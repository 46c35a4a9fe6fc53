"""The benchmark's general code: finding a cell's files, the window, the
trace, the check and the result line."""
