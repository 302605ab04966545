"""The native batch ring feeding the card: ``NativeBatchDataSetIterator(
device="cuda")`` gathers each batch on the C++ thread into pinned host
memory and copies it to the card with ``non_blocking=True`` on the
current stream. Every test here carries the ``cuda`` marker and skips
where there is no CUDA device; the file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest tests/test_torch_native_cuda.py -q

- An epoch of card batches equals the CPU ring's for the same seed, bit
  for bit (the same gather, then a copy).
- A pinned staging block is never rewritten while its copy is in flight:
  the stream is held busy (``torch.cuda._sleep``) while a whole epoch is
  pulled, so every copy is still queued when the ring writes the next
  batches; the caching host allocator must hand out another block for
  each, and every batch on the card must still equal the CPU's.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.datasets.iterators import \
    NativeBatchDataSetIterator

pytestmark = pytest.mark.cuda

N, B = 1000, 64


@pytest.fixture
def data():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if not native.available():
        pytest.fail(f"native library did not build: {native.build_error()}")
    rs = np.random.RandomState(0)
    x = rs.rand(N, 1, 28, 28).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, N)]
    return x, y


def _epoch(x, y, device, hold_ms=0):
    it = NativeBatchDataSetIterator(x, y, B, seed=3, device=device,
                                    drop_last=False)
    if hold_ms:
        # about hold_ms of work queued ahead of every copy of the epoch
        torch.cuda._sleep(int(hold_ms * 1.5e6))
    out = [(d.features.torch(), d.labels.torch()) for d in it]
    return out


def test_card_batches_equal_the_cpu_ring(data):
    x, y = data
    card, cpu = _epoch(x, y, "cuda"), _epoch(x, y, "cpu")
    torch.cuda.synchronize()
    assert len(card) == len(cpu) == -(-N // B)
    for (cx, cy), (hx, hy) in zip(card, cpu):
        assert cx.device.type == "cuda" and hx.device.type == "cpu"
        assert torch.equal(cx.cpu(), hx) and torch.equal(cy.cpu(), hy)


def test_a_pinned_block_is_not_rewritten_while_its_copy_is_queued(data):
    x, y = data
    cpu = _epoch(x, y, "cpu")
    for _ in range(3):
        card = _epoch(x, y, "cuda", hold_ms=200)
        torch.cuda.synchronize()
        for (cx, cy), (hx, hy) in zip(card, cpu):
            assert torch.equal(cx.cpu(), hx) and torch.equal(cy.cpu(), hy)
