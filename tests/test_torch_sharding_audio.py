"""The sharded steps of whisper-tiny's smoke arch (2 encoder and 2 decoder
layers, d 128, 4 heads of 32, d_ff 256, GELU, LayerNorm, QKV bias, 32
frames, f32) over 8 gloo ranks on a ``(2, 4)`` ``data × model`` mesh, held
against the port's single-process steps and JAX's by
``tests/test_torch_sharding_dist.py`` (see its docstring for every check
and bound); the frames (B, 32, D) are drawn with numpy from a seed, the
same arrays in both packages, and sharded on the batch.

Here also: the cross attention's ck/cv cache sharded on its 32 frames
(unpadded: the launcher pads only the sequence caches), and one decoder
layer's cross-attention decode as ``CommDebugMode`` saw it: the new
token's query heads gathered, and the softmax's max and sum and the
output's partial sum reduced over the frames' shards; nothing of 32
frames moved but the (32,) mask, sliced locally. The key biases take no
gradient in exact arithmetic (no RoPE), so the harness holds them against
the model's largest gradient.

And whisper's published 6 heads (``uneven_whisper``: the smoke arch at 6
heads of 32): on a ``model`` axis of 4 ``torch.chunk`` gives the ranks 2,
2, 2 and 0 heads (GSPMD pads to 8). A projection cut into pieces that
are not whole heads is made whole before its heads are split
(``attention.split_heads``), the attention runs on each rank's heads, an
empty output on the rank with none, and the heads are made whole before
they are merged; the prefill, 2 decode steps and a train step are held
against a single process's at the harness's bounds (its key biases left
out of the gradient bound, as above).
"""
import json

from test_torch_sharding_dist import check

ARCH, STRATEGY, SWA, LR = "whisper-tiny", "tp", None, (1e-2, 2, 10)


def test_sharded_audio_steps_match_single_process_and_jax(tmp_path, monkeypatch):
    out = check(tmp_path, monkeypatch, ARCH, STRATEGY, SWA, LR, extra="uneven_whisper")
    got, gaps = out["got"], out["gaps"]
    assert got["placement/batch_frames"] == "(Shard(dim=0), Replicate())"
    assert got["placement/encoder.layers.0.attn.wq"] == "(Shard(dim=0), Shard(dim=1))"
    assert got["placement/layers.0.cross_attn.wk"] == "(Shard(dim=0), Shard(dim=1))"
    assert got["placement/cache_k"] == "(Shard(dim=1), Shard(dim=2))"    # batch, sequence
    assert got["placement/cache_ck"] == "(Shard(dim=1), Shard(dim=2))"   # batch, frames
    assert got["placement/cache_cv"] == "(Shard(dim=1), Shard(dim=2))"
    assert gaps["zero_grad_leaves"] == [
        "encoder.layers.0.attn.bk", "encoder.layers.1.attn.bk", "layers.0.attn.bk",
        "layers.0.cross_attn.bk", "layers.1.attn.bk", "layers.1.cross_attn.bk"]
    moves = gaps["comm"]["redistributions"]
    # the query's heads made whole: the frames are sharded
    assert ["(Shard(dim=0), Shard(dim=2))", "(Shard(dim=0), Replicate())",
            [4, 1, 4, 32]] in moves, moves
    assert any(src.endswith("Partial(max))") for src, _, _ in moves), moves
    assert ["(Shard(dim=0), Partial(sum))", "(Shard(dim=0), Replicate())",
            [4, 4, 1, 1, 1]] in moves, moves
    # the attention's output (B, 1, H·hd) a partial sum over the frames' shards
    assert any(src.endswith("Partial(sum))") and shape == [4, 1, 128]
               for src, _, shape in moves), moves
    # no (B, 32, ...) tensor moved: the (32,) frame mask is the only one of 32
    assert not [m for m in moves if m[2][:2] == [4, 32]], moves
    assert ["(Replicate(), Replicate())", "(Replicate(), Shard(dim=0))", [32]] in moves
    # the published 6 heads on a model axis of 4 (2, 2, 2 and 0 a rank)
    uneven = json.loads(str(got["uneven_whisper"]))
    print("uneven_whisper", uneven)
    assert uneven["prefill"] <= 1e-5 and uneven["tokens_equal"]
    assert uneven["loss_rel"] <= 1e-5 and uneven["grads_rel"] <= 1e-5
    assert uneven["params_lr"] <= 0.1
