"""The least work of the cells' kernels and steps, counted from the shapes:
a frozen copy of the port's cost model (``counts``), kept with the
benchmark so that a change to the program cannot change its yardstick."""
