"""The benchmark's frozen yardstick: seeds, inputs, weights, statistics, traces."""
