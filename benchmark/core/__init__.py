"""The benchmark's general machinery: names to files, traffic, the system, the loop, tracing, the check."""
