"""Plain references, one module a configuration (`<config>.py`, found by
the configuration's name). Each gives `log_posterior(cfg, inputs, params,
tree, dtype, device) -> [B]` and `grad_heights(...) -> [B, M]` for the
chains' states, in the precision asked: float64 is the reference, and a
lower one the control that `correct` has to refuse. None of them imports
the program under test."""
