"""The examples of ``examples/``, written for the PyTorch port.

Each script runs on the card unless it is given ``--device cpu`` (a
keyword ``device="cpu"`` for callers), keeps its JAX counterpart's sizes
and assertions, and has a ``main(...)`` that returns its headline numbers
as a dict.  Run one as ``python3 examples_torch/<name>.py``.
"""
