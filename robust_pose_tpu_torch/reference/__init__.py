"""The reference network: the original PyTorch PoseNet and RAFT (with an
SE(3) module in lietorch's layout), reassembled module for module, with
the reference checkpoints' state_dict names, so that a reference ``.pth``
loads with ``strict=True``.

This is the port's own copy of ``tests/torch_ref``, changed only in its
imports: the port imports nothing from ``tests``. It is the oracle of
``scripts/verify_parity.py`` and of ``chip_smoke.py``'s parity phase, and
runs on the CPU in f32 (its pose head solves in f64). Nothing on the
tracking or training path imports it.
"""
