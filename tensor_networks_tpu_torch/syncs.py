"""Host synchronisations of one call, counted by where they come from.

Under ``torch.cuda.set_sync_debug_mode("warn")`` every call that makes
the host wait for the card warns.  Each warning is put down to the
innermost Python frame outside torch (the line that asked for the
sync) and classified by a pattern of that line's source, else named by
its ``file:line``.  Used to hold the fused solvers to one read a sweep.
"""

from __future__ import annotations

import os
import traceback
import warnings

import torch

#: (pattern of the source line, kind): the stop test and the record
#: fetch of a fused loop, cuSOLVER's status checks, ``svd_round``'s rank
#: read and any other float or int read
SYNC_KINDS = (("bool(flag)", "stop test"), (".cpu()", "record fetch"),
              ("torch.linalg.svd", "svd info"), ("torch.linalg.eigh", "eigh info"),
              ("torch.linalg.eigvalsh", "eigh info"),
              ("int(_trunc_count", "svd_round rank read"), ("float(", "host float"),
              ("int(", "host int"))


def host_syncs(fn):
    """One call of ``fn`` under the sync debug mode: ``(counts, result)``
    with ``counts`` the host syncs by kind."""
    torch_dir = os.path.dirname(torch.__file__)
    counts = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frame = next(f for f in reversed(traceback.extract_stack())
                     if not f.filename.startswith(torch_dir)
                     and not f.filename.endswith("warnings.py") and f.name != "hook")
        if frame.name == "host_syncs":  # setting the debug mode synchronises
            return
        kind = next((k for pat, k in SYNC_KINDS if pat in (frame.line or "")),
                    f"{os.path.basename(frame.filename)}:{frame.lineno}")
        counts[kind] = counts.get(kind, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return counts, out
