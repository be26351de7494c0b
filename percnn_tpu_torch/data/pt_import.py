"""Reference ``.pt`` checkpoints into the port's parameter trees.

Counterpart of percnn_tpu/data/pt_import.py.  The reference commits
trained PyTorch checkpoints per experiment (``torch.save({'model_state_dict',
'optimizer_state_dict'}, ...)``, train_2drd.py:417-424).  Importing them
lets the port validate rollouts against reference-trained weights and lets
a reference user continue a run here, Adam moments included.

``load_pt`` is ``torch.load(path, map_location="cpu", weights_only=True)``,
which reads both the legacy stream format (what the reference commits) and
the zip format, then turns every tensor into a numpy array.  The JAX
package parses the pickle itself and turns unknown objects into None;
``weights_only=True`` refuses a checkpoint that pickles anything beyond
tensors, containers and plain values.  The mappers return the JAX
package's numpy trees in its layout (channels-last weights), which
``bridge.params_from_numpy`` takes.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


class _PtArray(np.ndarray):
    """ndarray that remembers which checkpoint storage it came from.

    ``storage_ident = (storage address, offset, shape)`` at load time: two
    state-dict entries with the same ident are aliases of one nn.Parameter
    (the Burgers Stage-1 UpconvBlock registers up0/out AND a Sequential
    built from the same modules, so ``convnet.0.weight`` is ``up0.weight``,
    rcnn_Burgers...py:38-52).  torch's ``model.parameters()`` dedupes such
    aliases, which shifts optimizer-state indices; see map_adam_moments.
    Behaves as a plain array everywhere else (np.asarray drops the subclass).
    """

    storage_ident: tuple | None = None


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A contiguous copy as numpy; bfloat16 (which numpy lacks) widens to
    the float32 values it denotes."""
    src = t.detach()
    if src.dtype == torch.bfloat16:
        src = src.to(torch.float32)
    out = np.ascontiguousarray(src.numpy()).view(_PtArray)
    out.storage_ident = (t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape))
    return out


def _resolve(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return _to_numpy(obj)
    if isinstance(obj, dict):
        return {k: _resolve(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_resolve(v) for v in obj)
    return obj


def load_pt(path: str) -> Any:
    """Load a torch ``.pt`` checkpoint as a tree of numpy arrays.

    Both formats (legacy stream and zip) are read by torch itself, with
    ``weights_only=True``.  Tensors become contiguous numpy arrays; the
    storage they came from is kept as ``storage_ident`` for the aliasing
    rule of map_adam_moments (every storage of the file is alive while the
    idents are taken, so equal idents mean one storage).
    """
    return _resolve(torch.load(path, map_location="cpu", weights_only=True))


# --------------------------------------------------------------------------
# Layout mappers: reference state_dict names -> the JAX package's trees.
# --------------------------------------------------------------------------

def _conv_w(w: np.ndarray) -> np.ndarray:
    """torch Conv weight [Cout, Cin, *k] -> channels-last [*k, Cin, Cout]."""
    nd = w.ndim - 2
    return np.transpose(w, tuple(range(2, 2 + nd)) + (1, 0))


def _convt_w(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose weight [Cin, Cout, *k] -> [*k, Cin, Cout]."""
    nd = w.ndim - 2
    return np.transpose(w, tuple(range(2, 2 + nd)) + (0, 1))


def _pi_branch_w(w: np.ndarray) -> np.ndarray:
    """Pi branch conv weight -> cell layout ([Cin, Cout] when k=1)."""
    nd = w.ndim - 2
    hwio = _conv_w(w)
    if all(w.shape[2 + i] == 1 for i in range(nd)):
        return hwio.reshape(hwio.shape[-2:])  # 1x1: [Cin, Cout]
    return hwio


def _map_isg(sd: dict, prefix: str = "UpconvBlock.") -> dict | None:
    """Map reference ISG weights, auto-detecting the naming style.

    DataDrivenModeling scripts use a Sequential ('convnet.0' ConvT,
    'convnet.2' ConvT, 'convnet.3' 1x1 out, train_2drd.py:26-41); the
    discovery Stage-1/3 scripts use named members ('up0' ConvT, 'out' 1x1,
    rcnn_Burgers...py:38-52; those checkpoints also carry 'convnet.*'
    aliases of the same tensors, which are ignored for the named ones).
    """
    if f"{prefix}up0.weight" in sd:
        return {
            "up0_w": _convt_w(sd[f"{prefix}up0.weight"]),
            "up0_b": np.asarray(sd[f"{prefix}up0.bias"]),
            "out_w": _pi_branch_w(sd[f"{prefix}out.weight"]),
            "out_b": np.asarray(sd[f"{prefix}out.bias"]),
        }
    if f"{prefix}convnet.0.weight" in sd:
        return {
            "up0_w": _convt_w(sd[f"{prefix}convnet.0.weight"]),
            "up0_b": np.asarray(sd[f"{prefix}convnet.0.bias"]),
            "up1_w": _convt_w(sd[f"{prefix}convnet.2.weight"]),
            "up1_b": np.asarray(sd[f"{prefix}convnet.2.bias"]),
            "out_w": _pi_branch_w(sd[f"{prefix}convnet.3.weight"]),
            "out_b": np.asarray(sd[f"{prefix}convnet.3.bias"]),
        }
    return None


def map_pi_state_dict(sd: dict, *, cell_prefix: str = "crnn_cell.", n_branches: int = 3,
                      channel_names: tuple = ("u", "v"),
                      diff_names: tuple | None = None) -> tuple[dict, dict | None]:
    """Map a reference Pi-cell ``model_state_dict`` to (cell_params, isg_params).

    Reference module names (train_2drd.py:43-125, :26-41):
      crnn_cell.{CA,CB}                      -> diff logits [2]
      crnn_cell.Wh{1..3}_{u,v}.{weight,bias} -> pi[c] w0..w2 / b0..b2
      crnn_cell.Wh4_{u,v}.{weight,bias}      -> pi[c] w_out / b_out
      UpconvBlock.convnet.{0,2}.*  (ConvT)   -> isg up0/up1
      UpconvBlock.convnet.3.*      (1x1 out) -> isg out

    The LO forward solver names its raw diffusion scalars DA/DB
    (percnn_LO_eqn.py:42-43) and has no ISG: auto-detected.  The frozen
    ``W_laplace`` weight is ignored (the port's Laplacian is the same
    stencil applied as a roll-sum; see ops/stencils.py).
    """
    if diff_names is None:
        diff_names = ("CA", "CB") if cell_prefix + "CA" in sd else ("DA", "DB")
    diff = np.stack([np.asarray(sd[cell_prefix + n], np.float32).reshape(())
                     for n in diff_names])
    pi = []
    for cn in channel_names:
        branch = {}
        for i in range(n_branches):
            branch[f"w{i}"] = _pi_branch_w(sd[f"{cell_prefix}Wh{i + 1}_{cn}.weight"])
            branch[f"b{i}"] = np.asarray(sd[f"{cell_prefix}Wh{i + 1}_{cn}.bias"])
        branch["w_out"] = _pi_branch_w(sd[f"{cell_prefix}Wh{n_branches + 1}_{cn}.weight"])
        branch["b_out"] = np.asarray(sd[f"{cell_prefix}Wh{n_branches + 1}_{cn}.bias"])
        pi.append(branch)
    return {"diff": diff, "pi": pi}, _map_isg(sd)


def map_symbolic_state_dict(sd: dict, *, cell_prefix: str = "crnn_cell.",
                            channel_names: tuple = ("u", "v"),
                            n_terms: int | None = None) -> tuple[dict, dict | None]:
    """Map a reference Stage-3 ``model_state_dict`` to (symbolic_params, isg_params).

    Reference Stage-3 names (fine_tuning_[5%noise...].py:123-157):
      crnn_cell.nu_{u,v} -> nu [2];  crnn_cell.C{i}_{u,v} -> coef[c][i-1].
    Frozen derivative filters (laplace_op/dx_op/dy_op) are ignored: the
    port evaluates terms with roll-sum stencils.
    """
    nu = np.stack([np.asarray(sd[f"{cell_prefix}nu_{c}"], np.float32).reshape(())
                   for c in channel_names])
    coef = []
    for cn in channel_names:
        cs = []
        i = 1
        while n_terms is None or i <= n_terms:
            key = f"{cell_prefix}C{i}_{cn}"
            if key not in sd:
                break
            cs.append(np.asarray(sd[key], np.float32).reshape(()))
            i += 1
        coef.append(np.stack(cs))
    return {"nu": nu, "coef": coef}, _map_isg(sd)


def _map_state_dict_like(sd: dict, map_kwargs: dict):
    """The right layout mapper (Pi or symbolic) on a state-dict-shaped
    mapping: the weights themselves, and per-parameter optimizer moments
    (which transform identically, entry for entry)."""
    prefix = map_kwargs.get("cell_prefix", "crnn_cell.")
    if f"{prefix}nu_u" in sd:
        return map_symbolic_state_dict(sd, **map_kwargs)
    return map_pi_state_dict(sd, **map_kwargs)


def map_adam_moments(raw: dict, **map_kwargs) -> dict | None:
    """Map a reference ``optimizer_state_dict`` (torch.optim.Adam) to the
    JAX package's Adam moments.

    torch Adam state is keyed by parameter index into the param-group list,
    which for ``optim.Adam(model.parameters())`` follows module
    registration order over unique parameters: ``model.parameters()``
    dedupes aliased tensors, so checkpoints whose UpconvBlock registers the
    same convs twice (named members + a Sequential, rcnn_Burgers...py:38-52)
    have fewer optimizer slots than state-dict entries.  Aliases are found
    by the storages recorded by load_pt (``storage_ident``) and each moment
    goes to every alias name, so whichever name the layout mapper prefers
    sees it.  Frozen parameters (requires_grad=False, e.g. W_laplace) are
    in the index space but never get state; their moments stay zero.

    Returns {'mu': (cell, isg), 'nu': (cell, isg), 'count': int} with
    cell/isg shaped like the mapped weight trees (torch ``exp_avg`` /
    ``exp_avg_sq`` are the moments, ``step`` the count), or None when the
    checkpoint carries no optimizer state.  Raises ValueError where the
    positions cannot be matched to the state dict.
    """
    sd = raw.get("model_state_dict")
    opt = raw.get("optimizer_state_dict")
    if sd is None or not isinstance(opt, dict) or not opt.get("state"):
        return None
    # position space = registration order over unique parameters (aliases
    # dedupe to their first name, as torch's model.parameters() does)
    names = []          # unique position -> canonical name
    aliases = {}        # canonical name -> every name sharing its storage
    first_by_ident = {}
    for n, v in sd.items():
        ident = getattr(v, "storage_ident", None)
        if ident is not None and ident in first_by_ident:
            aliases[first_by_ident[ident]].append(n)
            continue
        if ident is not None:
            first_by_ident[ident] = n
        names.append(n)
        aliases[n] = [n]
    # two packings exist: state keyed by position index (modern torch) or
    # by raw param id() with param_groups carrying the same ids in
    # registration order (what the reference's checkpoints use)
    pg_ids = []
    for g in opt.get("param_groups") or []:
        pg_ids.extend(g.get("params") or [])
    id_to_pos = {int(pid): j for j, pid in enumerate(pg_ids)}
    if pg_ids and len(pg_ids) != len(names):
        # registered buffers live in the state dict but not in
        # model.parameters(); they shift every later position, and a
        # same-shaped buffer would dodge the per-tensor shape check below
        raise ValueError(
            f"checkpoint has {len(names)} unique state-dict tensors but its "
            f"optimizer tracks {len(pg_ids)} parameters; position-based "
            "moment assignment is ambiguous (registered buffers?)")
    mu_sd = {n: np.zeros_like(np.asarray(v)) for n, v in sd.items()}
    nu_sd = {n: np.zeros_like(np.asarray(v)) for n, v in sd.items()}
    count = 0
    for idx, st in opt["state"].items():
        k = int(idx)
        pos = id_to_pos[k] if k in id_to_pos else k
        if not 0 <= pos < len(names):
            raise ValueError(
                f"optimizer state key {k} resolves to position {pos}, out of "
                f"range for {len(names)} unique model parameters")
        for name in aliases[names[pos]]:
            ea = np.asarray(st["exp_avg"])
            if ea.shape != np.shape(sd[name]):
                raise ValueError(
                    f"optimizer state {k} (shape {ea.shape}) maps to "
                    f"parameter {name!r} (shape {np.shape(sd[name])}); the "
                    "checkpoint's parameter ordering doesn't match its "
                    "state dict (registered buffers?)")
            mu_sd[name] = ea
            nu_sd[name] = np.asarray(st["exp_avg_sq"])
        count = max(count, int(np.asarray(st["step"]).item()))
    mu_cell, mu_isg = _map_state_dict_like(mu_sd, map_kwargs)
    nu_cell, nu_isg = _map_state_dict_like(nu_sd, map_kwargs)
    return {"mu": (mu_cell, mu_isg), "nu": (nu_cell, nu_isg), "count": count}


def import_reference_checkpoint(path: str, **map_kwargs):
    """load_pt + the right mapper (Pi or symbolic cell, auto-detected).

    Returns (cell_params, isg_params, raw), raw being the whole decoded
    checkpoint (optimizer state included) for inspection."""
    raw = load_pt(path)
    sd = raw["model_state_dict"] if "model_state_dict" in raw else raw
    cell, isg = _map_state_dict_like(sd, map_kwargs)
    return cell, isg, raw
