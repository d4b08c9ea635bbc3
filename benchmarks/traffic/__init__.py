"""Traffic kinds: ``<kind>.py`` makes a cell's inputs from its parameters
and the seed, runs the measured window and judges what came back."""
