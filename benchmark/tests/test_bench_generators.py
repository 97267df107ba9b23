"""The traffic's inputs are made from the seed alone."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import cells, check, synth
from benchmark.harness.spec import mix_seed
from benchmark.reference import derive, icp as ref


def test_synth_cloud_and_frames_repeat_per_seed():
    a, b = synth.synth_cloud(1000, 7), synth.synth_cloud(1000, 7)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], synth.synth_cloud(1000, 8)[0])
    d0, c0 = synth.synth_depth_frame(3)
    d1, c1 = synth.synth_depth_frame(3)
    assert np.array_equal(d0, d1) and np.array_equal(c0, c1)
    assert d0.shape == (synth.TUM_H, synth.TUM_W) and c0.shape == (synth.TUM_H, synth.TUM_W, 4)
    assert not np.array_equal(d0, synth.synth_depth_frame(4)[0])


def test_seeds_and_draws_repeat():
    big = 2**31 + 12345
    assert mix_seed(big, 3, 1) == mix_seed(big, 3, 1) != mix_seed(big, 4, 1)
    assert 0 <= mix_seed(big, 3, 1) < 2**63 and mix_seed(-5, 0) == mix_seed(-5, 0)
    for spec in ({"axis": [0.0, 0.0, 1.0], "angle": [0.05, 0.2],
                  "translation": [[-1.0, 0.5], [-0.3, 0.45], [0.1, 0.1]]},
                 {"axis": "random", "angle": [0.0, 0.01], "translation": [[-0.005, 0.005]] * 3}):
        draw = cells.PoseDraw(spec, "cpu")
        p, q = draw(big, 2, 5), draw(big, 2, 5)
        assert torch.equal(p, q) and not torch.equal(p, draw(big, 3, 5))
        R = p[:, :3, :3]
        assert torch.allclose(R @ R.transpose(1, 2), torch.eye(3).expand(5, 3, 3), atol=1e-6)
        angle = torch.acos(((R.diagonal(dim1=1, dim2=2).sum(-1) - 1) / 2).clamp(-1, 1))
        assert (angle >= spec["angle"][0] - 1e-3).all() and (angle <= spec["angle"][1] + 1e-3).all()
    a = ref.gap_draws(big, 3, 1, 50_000, 0.01, 2, "cpu")
    b = ref.gap_draws(big, 3, 1, 50_000, 0.01, 2, "cpu")
    assert all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]) for x, y in zip(a, b))


def test_answer_sample_repeats_and_holds_the_last_call():
    s = check.sample_answers(99, 10, 176, 8)
    assert s == check.sample_answers(99, 10, 176, 8)
    assert s[0][0] == 9 and len(set(s)) == 8
    assert check.sample_answers(99, 1, 2, 8) == check.sample_answers(99, 1, 2, 8)
    assert len(check.sample_answers(99, 1, 2, 8)) == 2


def test_reference_orders_rows_as_the_program(bench):
    from icp_variants_tpu_torch.core import cloud as cloud_lib
    from icp_variants_tpu_torch.data import rgbd

    pts, nrm = synth.synth_cloud(3000, 5)
    port = cloud_lib.from_numpy(pts, normals=nrm, morton_order=True, device="cpu")
    mine = derive.padded_cloud(pts, nrm, morton_order=True)
    assert np.array_equal(port.points.numpy(), mine["points"])
    assert np.array_equal(port.valid.numpy(), mine["valid"])
    K, eye = synth.intrinsics(), np.eye(4, dtype=np.float32)
    depth, color = synth.synth_depth_frame(2)
    cap = synth.TUM_W * synth.TUM_H
    for layout, kw, down in (
            ("image", dict(keep_original_size=True, for_projective=True, capacity=cap), 1),
            ("full_colour_morton", dict(keep_original_size=True, color_morton_order=True,
                                        capacity=cap // 4, downsample_factor=4), 4),
            ("compact", dict(keep_original_size=False, capacity=cap), 1),
            ("compact_xyz_morton", dict(keep_original_size=False, downsample_factor=8,
                                        capacity=cap // 8, morton_order=True), 8)):
        port = rgbd.cloud_from_depth(depth, color, K, eye, device="cpu", **kw)
        mine = derive.depth_cloud(depth, color, K, layout, port.capacity, down)
        assert np.array_equal(port.points.numpy(), mine["points"]), layout
        assert np.array_equal(port.normals.numpy(), mine["normals"], equal_nan=True), layout
        assert np.array_equal(port.colors.numpy()[:, :3], mine["colors"]), layout
        assert np.array_equal(port.valid.numpy(), mine["valid"]), layout


def test_reference_draws_are_the_programs():
    from icp_variants_tpu_torch.ops import selection
    from icp_variants_tpu_torch.pipeline import icp

    cap, p, seed = 24_064, 0.01, 2**31 + 7
    k_cap = icp._compact_capacity(cap, p)
    assert k_cap == ref.compact_capacity(cap, p)
    gen = torch.Generator().manual_seed(seed)
    mine = ref.gap_draws(seed, 3, 2, cap, p, 2, "cpu")
    for t in range(2):
        rows, ok = selection.bernoulli_gap_indices(gen, p, 1, cap, k_cap, batch=(3,))
        assert torch.equal(rows[2].long(), mine[t][0]) and torch.equal(ok[2], mine[t][1])
