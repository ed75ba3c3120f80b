"""Kernels of the port: plain PyTorch oracles (``ref``), the CUDA kernels'
wrappers (``rff_klms_step``, ``rff_krls_step``, ``rff_predict``,
``rff_features``, ``rff_scan``, ``rff_attention``, ``flash_attention``,
built by ``_build``) and the ``mode=`` dispatch (``ops``)."""
