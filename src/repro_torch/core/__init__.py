"""Core learners: RFF feature maps (``rff``), the KLMS filter (``klms``)
and its bank tier (``bank``)."""
