"""The benchmark's machinery: loading a cell, the windows, the trace
reduction, the least-work yardstick and the comparison that decides
`correct`."""
