"""``blocked_attention``'s backward recomputes each key block, as the
reference's ``jax.checkpoint``-ed scan step does
(``repro.models.lm.common.blocked_attention``).

* The tensors autograd saves for the backward, recorded with
  ``torch.autograd.graph.saved_tensors_hooks`` at S = 512, 1024 and 2048
  with 128-key blocks (GQA, 2 query heads on 1 KV head): none has the
  scores' shape (a ``k_chunk``-wide last dim over the query rows: the
  scores, the probabilities, the masks), and
  what a key block saves is at most its carry (acc, m, l) and its inputs
  (the key and value block and their positions), at every S.  Without the
  checkpoint every block's s and p are saved, and both checks fail.
* Off a mesh the output and the q/k/v gradients are bit-equal to the same
  loop without the checkpoint (the recompute runs the same ops), in f32
  and in bf16, GQA and a sliding window included.
"""
import pytest
import torch

from repro_torch.models.lm import common

B, H, HK, D, Q_CHUNK, K_CHUNK = 1, 2, 1, 16, 64, 128


def _qkv(S, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(B, h, S, D, generator=g).to(dtype).requires_grad_()
                 for h in (H, HK, HK))


def _run(S, window=2 ** 30, dtype=torch.float32, record=None):
    q, k, v = _qkv(S, dtype)
    pos = torch.arange(S)

    def pack(t):
        if record is not None:
            record.append((tuple(t.shape), t.numel() * t.element_size()))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = common.blocked_attention(q, k, v, pos, pos, window, q_chunk=Q_CHUNK,
                                       k_chunk=K_CHUNK)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    grads = torch.autograd.grad(out, (q, k, v), g)
    return out.detach(), grads


def _scores_shaped(shape):
    # (B, H, nq, q_chunk, k_chunk) scores and probabilities, (nq, q_chunk,
    # k_chunk) masks, and their (B, H, nq * q_chunk, k_chunk) folds
    return len(shape) >= 2 and shape[-1] == K_CHUNK and shape[-2] % Q_CHUNK == 0


@pytest.mark.parametrize("S", [512, 1024, 2048])
def test_no_key_block_saves_its_scores(S):
    saved = []
    _run(S, record=saved)
    assert not [s for s, _ in saved if _scores_shaped(s)]
    nq, nk = S // Q_CHUNK, S // K_CHUNK
    carry = 4 * B * H * nq * Q_CHUNK * (D + 2)                # acc, m, l in f32
    inputs = 2 * 4 * B * HK * K_CHUNK * D + 8 * K_CHUNK       # k, v blocks, positions
    outside = 8 * 4 * B * H * nq * Q_CHUNK * (D + 2)          # the output's own, with room
    assert sum(n for _, n in saved) <= nk * (carry + inputs) + outside


@pytest.mark.parametrize("dtype,window", [(torch.float32, 2 ** 30), (torch.bfloat16, 2 ** 30),
                                          (torch.float32, 300)])
def test_recompute_is_bit_equal_to_the_unwrapped_loop(monkeypatch, dtype, window):
    out, grads = _run(512, window, dtype)
    # the same loop with the checkpoint a plain call
    monkeypatch.setattr(common, "checkpoint", lambda fn, *a, **kw: fn(*a))
    saved = []
    out0, grads0 = _run(512, window, dtype, record=saved)
    assert [s for s, _ in saved if _scores_shaped(s)]     # the loop unwrapped saves them
    assert torch.equal(out, out0)
    for g, g0 in zip(grads, grads0, strict=True):
        assert torch.equal(g, g0)
