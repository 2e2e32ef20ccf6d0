"""The program's spans on the card (``utils/profiling.py``'s recorder): the
host synchronisations it counts, and device times on the profiler's clock.

Runs on a CUDA card only, under a profiler that records CUDA activity alone
(as the benchmark's device trace opens it); skips without one. The machine
with the card has no JAX, so this file imports none:

    python -m pytest tests/test_torch_profiling_card.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from mikudance_tpu_torch.utils import profiling as pf


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device times come from CUDA events")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_count_planted_syncs_and_time_the_card(cuda):
    """Each planted blocking call counts once on the innermost span; a span
    that only launches counts none and does not wait for its kernel; every
    span's device interval is ordered and ends after its host start; the
    sync debug mode is put back when the request span closes."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device=cuda)
    a = np.ones(16, np.float32)
    # each kernel launched once first: the first launch of a kernel loads its
    # module, which waits for the card (no sync debug mode reports that wait)
    torch.cuda._sleep(1)
    (x * 2).sum()
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with profile(activities=[ProfilerActivity.CUDA]):
        with pf.span("request"):
            with pf.span("float"):
                float(x.sum())
            with pf.span("tensor"):
                torch.tensor(1.0, device=cuda)
            with pf.span("from_numpy"):
                torch.from_numpy(a).to(cuda)
            with pf.span("synchronize"):
                torch.cuda.synchronize()
            with pf.span("launch"):
                torch.cuda._sleep(100_000_000)
                (x * 2).sum()
            for _ in range(3):
                with pf.span("item"):
                    x[0].item()
        assert torch.cuda.get_sync_debug_mode() == mode
        torch.cuda.synchronize()
    spans = pf.recorded()
    syncs = {}
    for s in spans:
        syncs[s.name] = syncs.get(s.name, 0) + s.counters.get(pf.HOST_SYNCS, 0)
    print("host syncs by span:", syncs)
    assert syncs == {"request": 0, "float": 1, "tensor": 1, "from_numpy": 1, "synchronize": 0,
                     "launch": 0, "item": 3}
    for s in spans:
        assert s.device_ns[0] <= s.device_ns[1] and s.device_ns[1] >= s.host_ns[0], s
    launch = next(s for s in spans if s.name == "launch")
    print(f"launch: host {launch.host_ms:.3f} ms, device {launch.device_ms:.3f} ms, "
          f"device end - host end {(launch.device_ns[1] - launch.host_ns[1]) / 1e6:.3f} ms")
    assert launch.device_ms > 10 * launch.host_ms
    assert launch.device_ns[1] > launch.host_ns[1]
