"""Frozen operation and byte counts: the yardstick of the rooflines and of
``eval_mfu``, kept with the benchmark so that a change to the program
cannot move it.  One module a kernel or algorithm; every count is of what
the inputs need (each input byte read once, each output byte written once;
the cheaper of two algorithms where the kernels have a choice), in float32
operations of complex64 arithmetic (a complex product of ``(d, d)`` by
``(d, d)`` is ``8 d^3``)."""
