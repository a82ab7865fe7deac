"""The benchmark's own machinery: cell specs, traffic, clocks, traces."""
