"""The round's frozen work bound (portbench/roofline.py) over the device
time per mul call of the program's ``bank_fold`` operations alone, the
gathers and the scatter left out (%).  Listed in the 381-bit cell only:
its round's padded blocks move about ten times the L2, so the kernel
cannot find its inputs there."""


def read(rec):
    if rec.device is None:
        return None
    secs = sum(s for name, s in rec.device.top_ops(n=None)
               if "bank_fold" in name)
    return 100.0 * rec.bound_s * rec.device.n_calls / secs if secs else None
