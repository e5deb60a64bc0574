"""The benchmark's own arithmetic: the card's peaks, the model FLOPs of a
step, each kernel's least time from its shape, the device trace's sums and
the load generator. Nothing here reads the program: a change to the program
cannot move the yardstick."""
