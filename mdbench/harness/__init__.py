"""The general parts of the benchmark: the cell's files, the passes, the
window, the trace and the judgement of the results."""
