"""The harness: the cell's files by name, the measured window, the trace's
reduction and the result line."""
