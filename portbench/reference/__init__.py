"""Plain PyTorch references, one file a learner family, written from the
paper's equations (arXiv 1606.03685, §4 and §6) and the affine-trig map.
They import nothing of the program (``repro_torch``), of ``repro`` or of
JAX, and take only what the benchmark made: the map's W and b and the
inputs."""
