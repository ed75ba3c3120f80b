"""Step functions. The port has the two serving steps (prefill, decode);
the training steps wait (ROADMAP §1 entry 7)."""
