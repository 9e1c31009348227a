"""The yardstick's arithmetic against hand counts at one shape."""

import pytest

from benchmark.counts import base as counts
from benchmark.counts import count_of

SCORE = {"z_dim": 120, "z_scale": 32, "hidden_size": 1024, "num_heads": 16,
         "num_blocks": 24, "t_dim": 1024}


def test_score_blocks_by_hand():
    # a block's matmuls: qkv 1024x3072, fc_o 1024x1024, MLP 1024x4096 and
    # 4096x1024: 12,582,912 weights, 302M in 24 blocks; 2 FLOPs a weight a
    # token; attention 4 T^2 C a sample
    weights = 1024 * 3072 + 1024 * 1024 + 2 * 1024 * 4096
    assert weights * 24 == 301_989_888
    b, t = 64, 32
    want = 24 * (2 * weights * b * t + 4 * b * t * t * 1024)
    assert counts.score_blocks(SCORE, b) == want


def test_score_forward_by_hand():
    b = 2
    io = 2 * b * 32 * 120 * 1024 * 2
    cond = 2 * b * (256 * 1024 + 1024 * 1024) \
        + 24 * 2 * b * 1024 * 6144 + 2 * b * 1024 * 2048
    label = 2 * 2 * b * 1024 * 1024
    assert counts.score_forward(SCORE, b, mods=False) == \
        counts.score_blocks(SCORE, b) + io
    assert counts.score_forward(SCORE, b) == \
        counts.score_blocks(SCORE, b) + io + cond
    assert counts.score_forward(SCORE, b, label=True) == \
        counts.score_blocks(SCORE, b) + io + cond + label


def test_encode_by_hand():
    cfg = {"input_dim": 3, "hidden_dim": 4, "z_scales": 2, "p_dim": 4,
           "n_layers": 1, "encoder_layers": 1, "z_dim": 2, "outsize": 4}
    # one cloud of 4 points: 2 groups of 4 // 2 * 2 = 4 neighbours
    inp = 2 * 4 * 3 * 4
    group = 2 * 8 * 11 * 4 + 2 * (2 * 8 * 4 * 4)
    pos = 2 * 2 * 3 * 128 + 2 * 2 * 128 * 256 + 2 * 1 * 256 * 4
    tokens_block = 64 + 128 + 64 + 64 + 512   # q, k|v, attention, fc_o, MLP
    stage = tokens_block + 2 * 4 * 24 + 2 * 4 * 8 + 2 * 2 * 4 * 4
    posterior = tokens_block + 2 * 2 * 4 * 4
    decode = 2 * 2 * 2 * 4 + (128 + 128 + 128 + 128 + 1024)
    assert inp + group + pos + stage + posterior + decode == 139_584
    assert counts.encode(cfg, 1, 4) == 139_584


def test_self_attention_bound_by_hand():
    # K1 bf16 at B=64: 64 x 32 x 4096 x 2 bytes = 16.8 MB, bytes-bound
    t = counts.self_attention(64, 32, 1024, "bfloat16")
    assert t == pytest.approx(16_777_216 / 3.35e12)
    # K3 f32 at B=64: q|k|v, the output's gradient, q|k|v's: 58.7 MB
    t = counts.self_attention_bwd(64, 32, 1024, "float32")
    assert t == pytest.approx(64 * 32 * 7 * 1024 * 4 / 3.35e12)


def test_emd_bound_by_hand():
    # 64 pairs of 2048-point clouds: 9 N M exponentials each at 16 per SM
    # per clock, 132 SMs, 1.98 GHz: 0.5777 ms
    t = counts.emd_approx_match(64, 2048, 2048)
    assert t == pytest.approx(64 * 9 * 2048 * 2048 / (16 * 132 * 1.98e9))
    assert t * 1e3 == pytest.approx(0.5777, rel=1e-3)


AIRPLANE = {"score": SCORE,
            "compressor": {"input_dim": 3, "hidden_dim": 4, "z_scales": 2,
                           "p_dim": 4, "n_layers": 1, "encoder_layers": 1,
                           "z_dim": 2, "outsize": 4}}


@pytest.mark.parametrize("count, work, want", [
    # 8 stage-2 steps at B=2 of 4-point clouds: three forwards and the
    # encode (139,584 FLOPs a 4-point cloud, test_encode_by_hand) a step
    ("score_train_step", {"steps": 8, "batch": 2, "points": 4},
     8 * (3 * counts.score_forward(SCORE, 2)
          + counts.encode(AIRPLANE["compressor"], 2, 4))),
    # 32 labelled steps: the whole Score; unlabelled: modulations hoisted
    ("score_sample_step", {"steps": 32, "batch": 2, "label": True},
     32 * counts.score_forward(SCORE, 2, label=True)),
    ("score_sample_step", {"steps": 32, "batch": 2, "label": False},
     32 * counts.score_blocks(SCORE, 2) + 32 * 2 * 2 * 32 * 120 * 1024 * 2),
    # K1 f32 at B=32: q|k|v and the output, 32 x 32 x 4096 x 4 bytes,
    # 24 calls a step
    ("self_attention_sample", {"steps": 32, "batch": 32, "dtype": "float32"},
     32 * 24 * 32 * 32 * 4096 * 4 / 3.35e12),
    # K3 f32 at B=64: 7 C a token
    ("self_attention_bwd_train", {"steps": 8, "batch": 64,
                                  "dtype": "float32"},
     8 * 24 * 64 * 32 * 7 * 1024 * 4 / 3.35e12),
    # one eval call of 64 x 64 clouds: 3 x 64 x 64 pairs, 9 N M exps each
    ("emd_approx_match_eval", {"calls": 1, "clouds": 64, "points": 2048},
     3 * 64 * 64 * 9 * 2048 * 2048 / (16 * 132 * 1.98e9)),
])
def test_count_modules_by_hand(count, work, want):
    got = count_of({"count": count}, dict(work, config=AIRPLANE))
    assert got == pytest.approx(want, rel=1e-12)
