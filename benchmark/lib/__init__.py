"""The harness: cells, traffic, weights, windows, traces and the checks of `correct`."""
