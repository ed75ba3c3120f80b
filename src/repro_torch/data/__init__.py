"""Data generators: the paper's experiment streams (``synthetic``) and the
seekable LM token stream (``lm_data``)."""
