"""Frozen operation and byte counts, one module a kernel (`<kernel>.py`,
found by the kernel name a configuration gives), with the whole step's
count in `step.py`. Every count follows from shapes alone."""
