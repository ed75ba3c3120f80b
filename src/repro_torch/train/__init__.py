"""Training and serving steps, the trainer with checkpoint/restart and a
straggler watchdog, and elastic re-placement (``repro.train``)."""
