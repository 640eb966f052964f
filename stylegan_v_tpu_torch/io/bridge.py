"""Weight bridge: the JAX package's flax variable trees -> the port's state_dicts,
and its training state -> the port's (`jax_to_torch_train_state`), Adam's
moments included (`jax_to_torch_adam`); the metric detectors' variables ->
the port's detector modules (`jax_to_torch_i3d`, `jax_to_torch_inception`,
`jax_to_torch_c3d`, the inverses of the JAX package's `convert_*_state_dict`).

The inverse of stylegan_v_tpu/io/legacy.py:convert_generator_state and
convert_discriminator_state. Input is the flax variable tree as nested dicts
of numpy arrays; output is a state_dict of float32 CPU tensors with the
original StyleGAN-V names, for `load_state_dict`.

Layout conversions (flax -> port):
    linear    [in, out]        -> [out, in]
    conv2d    [kh, kw, I, O]   -> [O, I, kh, kw]
    conv1d    [k, I, O]        -> [O, I, k]       (motion_encoder.convN -> conv.N)
    const     [4, 4, C]        -> [C, 4, 4]
    embedding                  -> weight
    noise_const [H, W, 1]      -> [H, W]
    moving/mapping/w_avg       -> the mapping.w_avg buffer
    D epilogue fc: input rows from the flax HWC flatten to the port's CHW flatten
                               (under any prefix: MoCoGAN's image_discr.b4.fc too)
    conv3d    [kd, kh, kw, I, O] -> [O, I, kd, kh, kw]   (MoCoGAN's video D)
    LSTM      rnn/OptimizedLSTMCell_0/{ii,if,ig,io}.kernel, {hi,hf,hg,ho}.{kernel,bias}
                               -> rnn.{weight_ih_l0, weight_hh_l0, bias_ih_l0, bias_hh_l0}
                               (the inverse of stylegan_v_tpu/io/legacy.py:convert_lstm_state)

optax's `multi_transform` state (MoCoGAN's per-branch learning rates) holds
one Adam state per label, with masked nodes in the places of the other
label's parameters; `jax_to_torch_adam` merges them into one per-parameter
state.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        elif isinstance(val, tuple) and not val:
            continue          # optax's MaskedNode: a parameter of another label
        else:
            yield prefix + (key,), np.asarray(val, dtype=np.float32)


_GATES = "ifgo"         # nn.LSTM's row blocks, and flax's gate names


def _lstm_state(name: str, cell: Dict[Tuple[str, ...], np.ndarray]) -> Dict[str, np.ndarray]:
    """flax OptimizedLSTMCell leaves {(gate, kind): array} -> nn.LSTM's
    parameters under `name`: each gate's kernel [In, H] transposed into its
    row block, in (i, f, g, o) order; flax's one bias per gate into
    bias_ih_l0 and zeros into bias_hh_l0, whose sum nn.LSTM's cell adds."""
    bias = np.concatenate([cell[("h" + g, "bias")] for g in _GATES])
    return {f"{name}.weight_ih_l0": np.concatenate([cell[("i" + g, "kernel")].T
                                                    for g in _GATES]),
            f"{name}.weight_hh_l0": np.concatenate([cell[("h" + g, "kernel")].T
                                                    for g in _GATES]),
            f"{name}.bias_ih_l0": bias, f"{name}.bias_hh_l0": np.zeros_like(bias)}


def _convert_params(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    out, cells = {}, {}
    for path, arr in _leaves(params):
        if "rnn" in path:     # rnn/OptimizedLSTMCell_0/<gate>/<kind>
            i = path.index("rnn")
            cells.setdefault(".".join(path[:i + 1]), {})[path[i + 2:]] = arr
        else:
            name, arr = _convert_param(path, arr)
            out[name] = arr
    for name, cell in cells.items():
        out.update(_lstm_state(name, cell))
    return out


def _convert_param(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    leaf = path[-1]
    if leaf == "weight" and arr.ndim == 5:
        arr = arr.transpose(4, 3, 0, 1, 2)
    elif leaf == "weight" and arr.ndim == 2:
        arr = arr.T
    elif leaf == "weight" and arr.ndim == 3:
        arr = arr.transpose(2, 1, 0)
    elif leaf == "weight" and arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    elif leaf == "const":
        arr = arr.transpose(2, 0, 1)
    elif leaf == "embedding":
        path = path[:-1] + ("weight",)
    if path[-3:-2] == ("motion_encoder",) and path[-2] in ("conv0", "conv1"):
        path = path[:-2] + ("conv", path[-2][-1], leaf)            # an nn.Sequential
    return ".".join(path), arr


def _state_dict(named: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in named.items()}


def jax_to_torch_generator(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax Generator variables {'params', 'moving'?, 'buffers'?} -> Generator state_dict."""
    out = _convert_params(variables["params"])
    for path, arr in _leaves(variables.get("moving", {})):
        out[".".join(path)] = arr                                 # mapping.w_avg
    for path, arr in _leaves(variables.get("buffers", {})):
        out[".".join(path)] = arr[:, :, 0]                        # noise_const
    return _state_dict(out)


def jax_to_torch_discriminator(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax Discriminator or MoCoGANDiscriminator variables {'params'} -> the
    port's state_dict."""
    out = _convert_params(variables["params"])
    for name in [k for k in out if k == "b4.fc.weight" or k.endswith(".b4.fc.weight")]:
        w = out[name]                             # [out, 4*4*C], HWC order
        n_out = w.shape[0]
        out[name] = w.reshape(n_out, 4, 4, -1).transpose(0, 3, 1, 2).reshape(n_out, -1)
    return _state_dict(out)


def _adam_moments(opt_state):
    """optax.adam's ScaleByAdamState(count, mu, nu) inside its chain state."""
    for part in (opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)):
        if all(hasattr(part, k) for k in ("count", "mu", "nu")):
            return part
    raise ValueError(f"no Adam moments (count, mu, nu) in {type(opt_state).__name__}")


def _adam_states(opt_state) -> list:
    """Every Adam state of an optax state: one for optax.adam, one per label
    for optax.multi_transform (its inner_states, each a masked Adam)."""
    inner = getattr(opt_state, "inner_states", None)
    if inner is None:
        return [_adam_moments(opt_state)]
    return [_adam_moments(getattr(s, "inner_state", s)) for s in inner.values()]


def jax_to_torch_adam(opt_state, module: torch.nn.Module, convert) -> Dict[int, Dict[str, Any]]:
    """optax Adam state (plain, or multi_transform's per-label Adams) ->
    torch.optim.Adam's per-parameter `state`.

    optax's count, mu and nu become torch's step, exp_avg and exp_avg_sq,
    keyed by the index of each parameter in `module.parameters()`; each
    parameter takes the count of its label's Adam. `convert` is
    jax_to_torch_generator or jax_to_torch_discriminator, so each moment
    takes its parameter's layout change (the D epilogue fc's row permutation
    included)."""
    names = [n for n, _ in module.named_parameters()]
    merged: Dict[str, Dict[str, Any]] = {}
    for adam in _adam_states(opt_state):
        mu, nu = convert({"params": adam.mu}), convert({"params": adam.nu})
        step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
        for n in mu:
            merged[n] = {"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
    if set(names) != set(merged):
        raise KeyError(f"Adam moments and parameters differ: {sorted(set(names) ^ set(merged))}")
    return {i: merged[n] for i, n in enumerate(names)}


def jax_to_torch_train_state(state, G: Optional[torch.nn.Module] = None,
                             D: Optional[torch.nn.Module] = None) -> Dict[str, Any]:
    """The JAX package's TrainState -> the pieces of the port's TrainState.

    params_G and params_Gema are Generator state_dicts (their w_avg buffer
    taken from extra_G and extra_Gema), params_D a Discriminator state_dict;
    w_avg is G's buffer on its own; pl_mean, augment_p and ada_sign_acc are
    floats, step and cur_nimg ints. With the port's G and D (for their
    parameter order), opt_G and opt_D carry Adam's moments as
    torch.optim.Adam's per-parameter `state` (jax_to_torch_adam).
    """
    params_G = jax_to_torch_generator({"params": state.params_G, **state.extra_G})
    pieces = {
        "params_G": params_G,
        "params_D": jax_to_torch_discriminator({"params": state.params_D}),
        "params_Gema": jax_to_torch_generator({"params": state.params_Gema,
                                               **state.extra_Gema}),
        "w_avg": params_G["mapping.w_avg"],
        "pl_mean": float(np.asarray(state.pl_mean)),
        "augment_p": float(np.asarray(state.augment_p)),
        "ada_sign_acc": float(np.asarray(state.ada_sign_acc)),
        "step": int(np.asarray(state.step)),
        "cur_nimg": int(np.asarray(state.cur_nimg)),
    }
    if G is not None:
        pieces["opt_G"] = jax_to_torch_adam(state.opt_G, G, jax_to_torch_generator)
    if D is not None:
        pieces["opt_D"] = jax_to_torch_adam(state.opt_D, D, jax_to_torch_discriminator)
    return pieces


# ------------------------------------------------------------------ detectors

_UNIT_NAMES = {"bn_w": "bn.weight", "bn_b": "bn.bias", "bn_mean": "bn.running_mean",
               "bn_var": "bn.running_var"}


def _detector_units(variables: Mapping[str, Any], conv: str, conv_layout: Tuple[int, ...]
                    ) -> Dict[str, np.ndarray]:
    """The conv + batch-norm units of a flax detector, `params` and
    `batch_stats`, under the port's names: <path>.<conv>.weight/bias and
    <path>.bn.weight/bias/running_mean/running_var."""
    out = {}
    names = dict(_UNIT_NAMES, conv_w=f"{conv}.weight", conv_b=f"{conv}.bias")
    for col in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(col, {})):
            if path[-1] not in names:
                continue
            if path[-1] == "conv_w":
                arr = arr.transpose(conv_layout)
            out[".".join(path[:-1] + (names[path[-1]],))] = arr
    return out


def jax_to_torch_i3d(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax InceptionI3d variables {'params', 'batch_stats'} -> InceptionI3d
    state_dict (pytorch_i3d names; conv DHWIO -> OIDHW)."""
    return _state_dict(_detector_units(variables, "conv3d", (4, 3, 0, 1, 2)))


def jax_to_torch_inception(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax InceptionV3 variables {'params', 'batch_stats'} -> InceptionV3
    state_dict (conv HWIO -> OIHW; the head fc_w [2048, K] -> output.weight)."""
    out = _detector_units(variables, "conv", (3, 2, 0, 1))
    params = variables["params"]
    if "fc_w" in params:
        out["output.weight"] = np.asarray(params["fc_w"], np.float32).T
        out["output.bias"] = np.asarray(params["fc_b"], np.float32)
    return _state_dict(out)


def jax_to_torch_c3d(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax C3D variables {'params', 'preprocess'?} -> C3D state_dict: conv
    kernels [kt, kh, kw, I, O] -> [O, I, kt, kh, kw], dense [in, out] ->
    [out, in], and the mean cube [16, 112, 112, 3] -> the `mean` buffer
    [3, 16, 112, 112] (the per-channel fallback where there is none)."""
    from ..metrics.detectors.c3d import UCF101_MEAN_RGB
    out = {}
    for path, arr in _leaves(variables["params"]):
        layer, leaf = path[-2], path[-1]
        if leaf == "kernel":
            arr = arr.transpose(4, 3, 0, 1, 2) if arr.ndim == 5 else arr.T
        out[f"{layer}.{'weight' if leaf == 'kernel' else 'bias'}"] = arr
    pre = variables.get("preprocess")
    if pre is not None:
        out["mean"] = np.asarray(pre["mean_cube"], np.float32).transpose(3, 0, 1, 2)
    else:
        out["mean"] = np.broadcast_to(np.asarray(UCF101_MEAN_RGB, np.float32)[:, None, None, None],
                                      (3, 16, 112, 112))
    return _state_dict(out)
