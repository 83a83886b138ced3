"""The harness of the port's benchmark: discovery by name, the data and
weights, the program's build, the window, tracing and the check."""
