"""Data generators: the paper's experiment streams (``synthetic``)."""
