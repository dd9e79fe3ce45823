"""The program's device busy time per mul call (gathers, bank_fold, scatter),
from the profiler's trace, over the calls its sessions covered (ms)."""


def read(rec):
    if rec.device is None:
        return None
    return rec.device.busy_s(program_only=True) / rec.device.n_calls * 1e3
