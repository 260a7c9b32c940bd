"""Device-free analysis of the port: the meta-device support audit.

``repro_torch.analysis.abstract`` traces every registered config at full
width through each serving feature path on the ``meta`` device, the kernel
switches on, so every kernel's contract meets every full-width shape, and
classifies each config × path cell as ``supported`` / ``rejected`` /
``shape-error``. The generated ``support_matrix.json`` +
``SUPPORT_MATRIX.md`` sit beside it (the reference's snapshots at the
repo root belong to the reference's own audit).

The reference's AST linter (``python -m repro.analysis --lint``) already
scans ``src/repro_torch/``; it is repo tooling and is not ported.

Entry point: ``python -m repro_torch.analysis --audit [--write]``.
"""
from __future__ import annotations

from repro_torch.analysis.abstract import (  # noqa: F401
    FEATURE_PATHS,
    REFERENCE_DIFFERENCES,
    audit_all,
    audit_config,
    compare_matrices,
    render_markdown,
)
