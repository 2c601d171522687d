"""``data.loader.DevicePrefetcher`` and ``pin_batch`` of the PyTorch port.

No JAX here: the card test runs on machines without it
(``python -m pytest --noconftest -m cuda tests/test_torch_prefetch.py``).
On the CPU the prefetcher passes each batch as it is, one ahead; on the card it
pins the batch, copies it on a side stream, and hands it out once the current
stream waits on the copy's event (and ``record_stream`` keeps its memory).
"""

import numpy as np
import pytest
import torch

from valor_tpu_torch.data import loader as tld


def test_prefetcher_on_the_cpu_keeps_order_and_runs_one_ahead():
    pulled = []

    def source():
        for i in range(3):
            pulled.append(i)
            yield f"t{i}", {"x": np.full((2, 3), i, np.float32), "ids": [f"v{i}"]}

    pf = tld.DevicePrefetcher(source(), "cpu")
    assert pulled == [0]  # the first pair is fetched when the prefetcher is made
    out = []
    for task, batch in pf:
        out.append((task, float(batch["x"][0, 0]), batch["ids"]))
        assert len(pulled) == min(len(out) + 1, 3)  # one pair ahead of the caller
    assert out == [(f"t{i}", float(i), [f"v{i}"]) for i in range(3)]


@pytest.mark.cuda
def test_cuda_prefetcher_matches_a_blocking_copy():
    """Pinned buffers, copies on the side stream, the event and record_stream:
    every batch equals a plain blocking copy, read after more work was queued
    on the current stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(0)
    batches = [{"video_pixels": rng.randint(0, 256, (8, 4, 64, 64, 3), dtype=np.uint8),
                "audio_waveforms": rng.randn(8, 2, 20000).astype(np.float32),
                "ids": [str(i)]} for i in range(6)]
    pf = tld.DevicePrefetcher(iter([("task", b) for b in batches]), "cuda")
    assert pf.stream is not None and pf.stream != torch.cuda.current_stream()
    for (task, got), want in zip(pf, batches):
        busy = torch.randn(2048, 2048, device="cuda")
        for _ in range(4):
            busy = busy @ busy / 2048  # keep the current stream busy while the next copy runs
        assert task == "task" and got["ids"] == want["ids"]
        for k in ("video_pixels", "audio_waveforms"):
            assert got[k].is_cuda
            assert torch.equal(got[k], torch.from_numpy(want[k]).cuda())
    pinned = tld.pin_batch(batches[0])
    assert pinned["video_pixels"].is_pinned() and pinned["ids"] == ["0"]
