"""Card tests of the benchmark's comparisons: each imaging cell's control,
the reference with TF32 matrix products in the program's place, fails the
cell's check, at sizes a test run holds.

    python -m pytest benchmark/tests/test_bench_card.py -q -m cuda

They carry the ``cuda`` marker and skip without a card.  The readings at
the cells' own sizes, over a dozen seeds and the control's three, are made
by ``benchmark/run.py`` and ``benchmark/control.py`` (PERF.md).
"""

import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))

from harness.main import Window  # noqa: E402
from harness.spec import load_spec, system_adapter  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the program's kernels have no CPU mode here")
    return torch.device("cuda", 0)


def _spec(cell: str, **traffic):
    spec = load_spec(ROOT, cell)
    spec.traffic.update(traffic)
    return spec


SMALL = {"imaging_batch": {"files_per_day": 8, "pool": 4, "chunks_per_s": 1.0,
                           "warm_chunks": 1},
         "imaging_serve_overload": {"pool": 4}}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_imaging_tf32_control_fails(card, cell):
    from harness.main import Context

    spec = _spec(cell, **SMALL[cell])
    system = system_adapter("imaging")
    ctx = Context(root=ROOT, spec=spec, seed=3000000061, seconds=1.0, trace=False,
                  device=card)
    system.setup(ctx)
    system.release(ctx)
    checks = system.check(ctx, Window({}, 0, 0, outputs=system.control_outputs(ctx)))
    assert any(not c.ok for c in checks), checks
