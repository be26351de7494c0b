"""The port's reference-checkpoint import (data/pt_import.py) against
percnn_tpu's on the same .pt files, written here with torch.save in both
formats (the legacy stream the reference commits, and zip): the mapped
weight trees and Adam moments must be equal, leaf for leaf and dtype for
dtype, and both packages must raise on the same bad optimizer states."""

import numpy as np
import pytest
import torch

from percnn_tpu.data import pt_import as jpt

from percnn_tpu_torch.core.checkpoint import flatten_with_paths
from percnn_tpu_torch.data import pt_import as pt

FORMATS = {"legacy": False, "zip": True}


class _Seq2(torch.nn.Module):
    """The DataDrivenModeling ISG: a Sequential of two ConvT stages and a
    1x1 conv (train_2drd.py:26-41)."""

    def __init__(self, hidden):
        super().__init__()
        self.convnet = torch.nn.Sequential(
            torch.nn.ConvTranspose2d(2, hidden, 5, 2, 2, 1), torch.nn.Sigmoid(),
            torch.nn.ConvTranspose2d(hidden, hidden, 5, 2, 2, 1),
            torch.nn.Conv2d(hidden, 2, 1))


class _Aliased(torch.nn.Module):
    """The discovery scripts' ISG: named members, and a Sequential over the
    same modules (rcnn_Burgers...py:38-52)."""

    def __init__(self, hidden):
        super().__init__()
        self.up0 = torch.nn.ConvTranspose2d(2, hidden, 5, 2, 2, 1)
        self.out = torch.nn.Conv2d(hidden, 2, 1)
        self.convnet = torch.nn.Sequential(self.up0, torch.nn.Tanh(), self.out)


class _PiCell(torch.nn.Module):
    def __init__(self, hidden, k, buffer=False):
        super().__init__()
        self.CA = torch.nn.Parameter(torch.tensor(0.3))
        self.CB = torch.nn.Parameter(torch.tensor(-0.2))
        if buffer:
            # a registered buffer: in the state dict, not in parameters()
            self.register_buffer("W_laplace", torch.randn(1, 1, 5, 5))
        else:
            self.W_laplace = torch.nn.Parameter(torch.randn(1, 1, 5, 5), requires_grad=False)
        for cn in "uv":
            for i in (1, 2, 3):
                setattr(self, f"Wh{i}_{cn}", torch.nn.Conv2d(2, hidden, k, padding=k // 2))
            setattr(self, f"Wh4_{cn}", torch.nn.Conv2d(hidden, 1, 1))


class _SymbolicCell(torch.nn.Module):
    """The Stage-3 cell (fine_tuning_[5%noise...].py:123-157): nu and C_i
    per channel, frozen derivative filters."""

    def __init__(self, n_terms):
        super().__init__()
        self.nu_u = torch.nn.Parameter(torch.tensor(0.01))
        self.nu_v = torch.nn.Parameter(torch.tensor(0.02))
        for cn in "uv":
            for i in range(1, n_terms + 1):
                setattr(self, f"C{i}_{cn}", torch.nn.Parameter(torch.randn(1)))
        self.laplace_op = torch.nn.Parameter(torch.randn(1, 1, 5, 5), requires_grad=False)


class _Model(torch.nn.Module):
    def __init__(self, isg, cell):
        super().__init__()
        self.UpconvBlock = isg
        self.crnn_cell = cell


def _build(kind):
    torch.manual_seed({"gs2d": 0, "burgers": 1, "symbolic": 2, "buffer": 3}[kind])
    if kind == "gs2d":
        return _Model(_Seq2(8), _PiCell(8, 1))
    if kind == "burgers":
        return _Model(_Aliased(4), _PiCell(4, 5))
    if kind == "symbolic":
        return _Model(_Aliased(4), _SymbolicCell(3))
    return _Model(_Seq2(4), _PiCell(4, 1, buffer=True))


def _train(model, steps=3):
    opt = torch.optim.Adam([p for p in model.parameters()], lr=1e-2)
    for _ in range(steps):
        opt.zero_grad()
        loss = sum((p.float() ** 2).sum() * (i + 1) for i, p in
                   enumerate(p for p in model.parameters() if p.requires_grad))
        loss.backward()
        opt.step()
    return opt.state_dict()


def _id_keyed(osd, base=140213874500000):
    """The packing of the reference's checkpoints: state keyed by raw param
    id, param_groups listing the same ids in registration order."""
    ids = {}
    groups = []
    for g in osd["param_groups"]:
        g = dict(g)
        g["params"] = [ids.setdefault(i, base + 64 * i) for i in g["params"]]
        groups.append(g)
    return {"state": {ids[i]: st for i, st in osd["state"].items()}, "param_groups": groups}


def _write(tmp_path, kind, fmt, keyed="index"):
    model = _build(kind)
    osd = _train(model)
    if keyed == "id":
        osd = _id_keyed(osd)
    elif keyed == "bare":
        osd = {"state": osd["state"], "param_groups": []}   # positions alone
    path = str(tmp_path / f"{kind}_{fmt}_{keyed}.pt")
    torch.save({"model_state_dict": model.state_dict(), "optimizer_state_dict": osd}, path,
               _use_new_zipfile_serialization=FORMATS[fmt])
    return path


def _assert_trees_equal(got, want):
    g, w = flatten_with_paths(got), flatten_with_paths(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        if a is None or b is None:
            assert a is None and b is None, p
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert np.array_equal(a, b), p


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("kind, keyed", [("gs2d", "index"), ("gs2d", "id"),
                                         ("burgers", "index"), ("burgers", "id"),
                                         ("symbolic", "index")])
def test_import_equals_jax(tmp_path, kind, keyed, fmt):
    path = _write(tmp_path, kind, fmt, keyed)
    cell, isg, raw = pt.import_reference_checkpoint(path)
    jcell, jisg, jraw = jpt.import_reference_checkpoint(path)
    _assert_trees_equal((cell, isg), (jcell, jisg))
    moments = pt.map_adam_moments(raw)
    jmoments = jpt.map_adam_moments(jraw)
    assert moments["count"] == jmoments["count"] == 3
    _assert_trees_equal(moments["mu"], jmoments["mu"])
    _assert_trees_equal(moments["nu"], jmoments["nu"])
    if kind == "symbolic":
        assert set(cell) == {"nu", "coef"} and len(cell["coef"][0]) == 3
    else:
        assert set(isg) == ({"up0_w", "up0_b", "up1_w", "up1_b", "out_w", "out_b"}
                            if kind == "gs2d" else {"up0_w", "up0_b", "out_w", "out_b"})
    # every trained leaf got its moments; nothing is left at zero
    for p, leaf in flatten_with_paths(moments["mu"]):
        assert leaf is None or np.any(np.asarray(leaf) != 0), p


def test_aliases_share_a_storage_ident(tmp_path):
    raw = pt.load_pt(_write(tmp_path, "burgers", "legacy"))
    sd = raw["model_state_dict"]
    ident = lambda k: sd[k].storage_ident  # noqa: E731
    assert ident("UpconvBlock.up0.weight") == ident("UpconvBlock.convnet.0.weight")
    assert ident("UpconvBlock.out.bias") == ident("UpconvBlock.convnet.2.bias")
    assert ident("UpconvBlock.up0.weight") != ident("UpconvBlock.out.weight")


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("keyed, match", [("id", "optimizer tracks"),
                                          ("index", "optimizer tracks"),
                                          ("bare", "doesn't match its state dict")])
def test_buffer_shifted_state_raises_in_both(tmp_path, keyed, match, fmt):
    """A registered buffer sits in the state dict but not in parameters():
    with param groups (keyed by id or by index) the counts disagree; keyed
    by index without them, a moment lands on a tensor of another shape.
    Both packages refuse."""
    path = _write(tmp_path, "buffer", fmt, keyed)
    with pytest.raises(ValueError, match=match):
        pt.map_adam_moments(pt.load_pt(path))
    with pytest.raises(ValueError, match=match):
        jpt.map_adam_moments(jpt.load_pt(path))


def test_out_of_range_state_key_raises_in_both(tmp_path):
    model = _build("gs2d")
    osd = _train(model)
    osd["state"][999] = osd["state"][0]
    path = str(tmp_path / "bad.pt")
    torch.save({"model_state_dict": model.state_dict(), "optimizer_state_dict": osd}, path)
    for lib in (pt, jpt):
        raw = lib.load_pt(path)
        raw["optimizer_state_dict"]["param_groups"] = []
        with pytest.raises(ValueError, match="out of range"):
            lib.map_adam_moments(raw)


def test_no_optimizer_state_gives_none(tmp_path):
    model = _build("gs2d")
    path = str(tmp_path / "weights.pt")
    torch.save({"model_state_dict": model.state_dict()}, path)
    assert pt.map_adam_moments(pt.load_pt(path)) is None
    assert jpt.map_adam_moments(jpt.load_pt(path)) is None


def test_bf16_decodes_to_f32(tmp_path):
    vals = torch.tensor([1.5, -2.25, 3.0e-3, 0.0], dtype=torch.bfloat16)
    path = str(tmp_path / "bf16.pt")
    torch.save({"w": vals}, path, _use_new_zipfile_serialization=False)
    got = pt.load_pt(path)["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jpt.load_pt(path)["w"])
