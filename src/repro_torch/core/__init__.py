"""Core learners: RFF feature maps (``rff``), the KLMS filter (``klms``),
the dense KRLS filter (``krls``) and their bank tiers (``bank``)."""
