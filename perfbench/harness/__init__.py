"""The benchmark's harness: the cell's data, its inputs, the run, the trace
reduction, the work counts and the comparison with the reference."""
