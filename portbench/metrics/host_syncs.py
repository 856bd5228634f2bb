"""host_syncs: the reads of device tensors to the host (each a host sync)
that the program counts (``eeyore_tpu_torch/utils/host.py``) inside a job,
a job (traced)."""

from harness.program_spans import per_job


def read(ctx):
    return per_job(ctx, "host_syncs")
