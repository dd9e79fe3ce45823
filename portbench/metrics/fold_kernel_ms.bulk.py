"""The device time per mul call of the program's operations whose names
contain ``bank_fold`` (the fused round's kernel, without the gathers and
the scatter around it), from the profiler's trace, over the calls its
sessions covered (ms)."""


def read(rec):
    if rec.device is None:
        return None
    secs = sum(s for name, s in rec.device.top_ops(n=None)
               if "bank_fold" in name)
    return secs / rec.device.n_calls * 1e3 if secs else None
