"""Step functions. The port has the two serving steps (prefill, decode);
the training steps wait (ROADMAP §1 item 11)."""
