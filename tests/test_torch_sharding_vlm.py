"""The sharded steps of qwen2-vl-72b's smoke arch (2 layers, d 128, 4/4
heads of 32, QKV bias, M-RoPE sections (4, 6, 6), 8 stub patch
embeddings, f32) over 8 gloo ranks on a ``(2, 4)`` ``data × model`` mesh,
held against the port's single-process steps and JAX's by
``tests/test_torch_sharding_dist.py`` (see its docstring for every check
and bound). The patch embeddings (B, 8, D) and the (3, B, S) M-RoPE
positions (random in [0, 128), so every stream moves the rotation) are
drawn with numpy from a seed, the same arrays in both packages: the
positions sharded on their batch dim 1, the embeddings on dim 0, written
over the first prompt rows in the batch's placement. The decode's plain
(3, B, 1) positions meet the DTensors as replicated; one layer's decode
attention moved nothing of a cache's shape. And the steps with the
residual stream's sequence on ``model`` (``seq_residual_vlm``, the dry
run's ``--auto`` choice) against a single process's.
"""
from test_torch_sharding_dist import assert_seq_residual, check

ARCH, STRATEGY, SWA, LR = "qwen2-vl-72b", "tp", None, (1e-2, 2, 10)


def test_sharded_vlm_steps_match_single_process_and_jax(tmp_path, monkeypatch):
    out = check(tmp_path, monkeypatch, ARCH, STRATEGY, SWA, LR, extra="seq_residual_vlm")
    got, gaps = out["got"], out["gaps"]
    assert got["placement/batch_positions"] == "(Shard(dim=1), Replicate())"
    assert got["placement/batch_vision_embeds"] == "(Shard(dim=0), Replicate())"
    assert got["placement/batch_tokens"] == "(Shard(dim=0), Replicate())"
    assert got["placement/layers.0.attn.wq"] == "(Shard(dim=0), Shard(dim=1))"
    assert got["placement/cache_k"] == "(Shard(dim=1), Shard(dim=2))"    # batch, sequence
    moves = gaps["comm"]["redistributions"]
    assert moves and not [m for m in moves if m[2] in ([4, 36, 4, 32], [2, 4, 36, 4, 32])]
    assert_seq_residual(got)     # the residual stream's sequence on model
