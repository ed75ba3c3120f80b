"""The program side of each learner family, one file a family: its
fresh bank state, the hyperparameters its
chunk step takes, the keyword arguments of ``reset_slots`` and the state
leaves the comparison reads. Only these files and ``system.py`` import
the program (``repro_torch``)."""
