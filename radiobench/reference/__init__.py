"""The plain references and the checks that decide ``correct``.  They
import neither JAX nor anything of the program; each check module has
``judge(run, window) -> [harness.Compared]``."""
