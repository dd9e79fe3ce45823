"""Over the window's serve calls: requests a round carried over the
power-of-two bucket rows it ran, from the program's counters
``worker.rows`` and ``worker.bucket_rows`` (%)."""
from portbench import program_spans


def read(rec):
    rows = program_spans.counter_per_call(rec, "worker.rows")
    padded = program_spans.counter_per_call(rec, "worker.bucket_rows")
    if rows is None or not padded:
        return None
    return 100.0 * rows / padded
