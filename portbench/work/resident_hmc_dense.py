"""Work of one call of the dense HMC whole-loop kernel: the same as the
staged kernel's (``work/resident_hmc.py``); the data are part of its code,
and are counted as read once all the same."""

from work.resident_hmc import work  # noqa: F401
