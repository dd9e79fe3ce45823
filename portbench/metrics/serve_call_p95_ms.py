"""95th percentile of the wall time of every serve call in the window (ms)."""
import statistics


def read(rec):
    if rec.n_calls < 2:
        return None
    return statistics.quantiles(rec.call_s, n=20, method="inclusive")[18] * 1e3
