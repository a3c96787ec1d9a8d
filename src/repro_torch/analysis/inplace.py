"""The runtime twin of lint rule TL005: an in-place write that autograd sees.

A kernel launched through raw ``data_ptr()``s writes behind autograd's back
unless its wrapper bumps the version counter of what it wrote
(``torch.autograd.graph.increment_version``), as a torch in-place op does.
:func:`guard_saved` holds one launch to that: ``chip_smoke.py`` phase 2 on
the card, and ``tests/test_torch_kernels{,_cuda}.py`` on the plain versions
and the wrappers.
"""

from __future__ import annotations

from typing import Callable

import torch


def guard_saved(written: dict, launch: Callable[[], object]) -> dict:
    """Save each floating tensor of ``written`` ({name: tensor}) in a tiny
    graph of its own (``sum(w * t)`` keeps ``t`` for ``w``'s gradient), run
    ``launch``, which writes them all in place, and hold the result to what
    a torch in-place op gives: each tensor's autograd version advanced, and
    each graph's backward refuses the changed tensor.  Raises
    ``AssertionError`` naming the tensor otherwise.  Returns {name: version
    step}."""
    graphs = {}
    for k, t in written.items():
        loss = None
        if t.is_floating_point():
            w = torch.ones((), dtype=t.dtype, device=t.device, requires_grad=True)
            loss = (w * t).sum()
        graphs[k] = (loss, t._version)
    launch()
    steps = {}
    for k, t in written.items():
        loss, before = graphs[k]
        steps[k] = t._version - before
        if steps[k] <= 0:
            raise AssertionError(f"writing {k} left its autograd version at {before}")
        if loss is None:
            continue
        try:
            loss.backward()
        except RuntimeError as e:
            if "modified by an inplace operation" not in str(e):
                raise AssertionError(f"backward through the saved {k} raised {e}") from e
        else:
            raise AssertionError(f"a backward that saved {k} ran after the launch wrote it")
    return steps
