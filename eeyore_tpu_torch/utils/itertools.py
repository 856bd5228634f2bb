def chunk_evenly(iterable, n):
    """Split ``iterable`` into chunks of size ~n, spreading the remainder one
    element at a time over the leading chunks.

    Counterpart of ``eeyore_tpu/utils/itertools.py::chunk_evenly`` (Gibbs
    node sub-blocking): with r = len % n, the first r chunks get n+1
    elements and the rest get n; there are len // n chunks, so a sequence
    shorter than n gives none.
    """
    items = list(iterable)
    total = len(items)
    if n <= 0:
        raise ValueError("chunk size must be positive")
    remainder = total % n
    start = 0
    for i in range(total // n):
        size = n + 1 if i < remainder else n
        yield items[start:start + size]
        start += size
