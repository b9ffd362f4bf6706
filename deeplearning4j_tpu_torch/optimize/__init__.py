"""Updaters and gradient normalization of the port (``updaters``), the
bucketed update every fit runs (``fused_update``), the full-batch solvers
(``solvers``) and the training listeners (``listeners``)."""
