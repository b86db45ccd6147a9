"""Multi-device scale-out: meshes, sharded epochs, the distributed FFT."""
