"""The share of the burst receiver's clock-recovery rows that is padding:
100 x (1 - the bursts' samples / the buckets' samples, each bucket's rows
rounded up to a power of two times its length), over the window, from the
program's burst counter (``ops.wpcr.TOTALS``) as the driver read it
around the window.  None where the program has no such counter or the
window cut no burst."""


def read(run, window, trace):
    counted = (window.outputs or {}).get("wpcr_totals")
    if not counted or not counted.get("padded_samples"):
        return None
    return 100.0 * (1.0 - counted["burst_samples"] / counted["padded_samples"])
