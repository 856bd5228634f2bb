"""library_builds: the kernel libraries the program compiles inside a job
(``eeyore_tpu_torch/ops/_build.load_counts["builds"]``), a job (traced).
Every shape is built in the warm-up, so a steady job builds none: anything
above 0 is a library that was built again."""

from harness.program_spans import per_job


def read(ctx):
    return per_job(ctx, "builds")
