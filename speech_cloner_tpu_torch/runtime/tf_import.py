"""Import the reference's TF-1.x checkpoints into the JAX package's tree layout.

Counterpart of ``speech_cloner_tpu/runtime/tf_import.py``, with numpy leaves
instead of jax arrays; ``runtime/jax_params.py`` then turns the trees into
modules, as it does for ``.npz`` checkpoints. The bundle files are parsed by
the port's own reader (``runtime/tf_bundle.py``); TensorFlow is not needed.

Name mapping (TF -> tree):
  <scope>/prenet/dense{1,2}/{kernel,bias}                -> params[prenet][dense{1,2}]
  <scope>/CBHG/conv1d_banks/conv1d/conv1d/kernel         -> params[CBHG][banks][kernels][0]
  <scope>/CBHG/conv1d_banks/num_{k}/conv1d/conv1d/kernel -> params[CBHG][banks][kernels][k-1]
  <scope>/CBHG/conv1d_banks/bn/{gamma,beta}              -> params[CBHG][banks][bn]
  <scope>/CBHG/conv1d_banks/bn/moving_{mean,variance}    -> state[CBHG][banks][bn]
  <scope>/CBHG/conv1d_{1,2}/conv1d/kernel                -> params[CBHG][conv1d_{1,2}]
  <scope>/CBHG/conv1d_{1,2}/{gamma,beta,moving_*}        -> params/state[CBHG][bn{1,2}]
  <scope>/CBHG/highwaynet_{i}/dense{1,2}/{kernel,bias}   -> params[CBHG][highway][i]
  <scope>/CBHG/gru/bidirectional_rnn/{fw,bw}/gru_cell/
      {gates,candidate}/{kernel,bias}                    -> params[CBHG][gru][{fw,bw}]
  <scope>/y_logits/{kernel,bias}                         -> params[y_logits]

The tensor layouts are the tree's (dense [in,out], conv [k,in,out], GRU
[(in+h), 2h|h]), so the import only relabels; no transposes. A bundle whose
CBHG holds an LSTM (``<scope>/CBHG/gru/bidirectional_rnn/fw/lstm_cell/``)
is refused, as the JAX importer, which knows the GRU's names only, fails on
it.
"""

from __future__ import annotations

import numpy as np

from .tf_bundle import BundleReader


def _get(reader: BundleReader, name: str) -> np.ndarray:
    return np.asarray(reader.get_tensor(name))


def _import_dense(reader, prefix):
    return {"kernel": _get(reader, f"{prefix}/kernel"), "bias": _get(reader, f"{prefix}/bias")}


def _import_bn(reader, prefix):
    params = {"gamma": _get(reader, f"{prefix}/gamma"), "beta": _get(reader, f"{prefix}/beta")}
    state = {"mean": _get(reader, f"{prefix}/moving_mean"),
             "var": _get(reader, f"{prefix}/moving_variance")}
    return params, state


def _import_gru_dir(reader, prefix):
    return {
        "gates_kernel": _get(reader, f"{prefix}/gru_cell/gates/kernel"),
        "gates_bias": _get(reader, f"{prefix}/gru_cell/gates/bias"),
        "candidate_kernel": _get(reader, f"{prefix}/gru_cell/candidate/kernel"),
        "candidate_bias": _get(reader, f"{prefix}/gru_cell/candidate/bias"),
    }


def _import_cbhg(reader, scope, num_banks, num_highway):
    if reader.has_tensor(f"{scope}/gru/bidirectional_rnn/fw/lstm_cell/kernel"):
        # the JAX importer knows the GRU's names only, and fails on these
        raise ValueError(f"{scope}/gru holds an LSTM (lstm_cell): TF bundles of use_lstm "
                         "models are not imported, as in the JAX package")
    kernels = [_get(reader, f"{scope}/conv1d_banks/conv1d/conv1d/kernel")]
    for k in range(2, num_banks + 1):
        kernels.append(_get(reader, f"{scope}/conv1d_banks/num_{k}/conv1d/conv1d/kernel"))
    banks_bn_p, banks_bn_s = _import_bn(reader, f"{scope}/conv1d_banks/bn")
    bn1_p, bn1_s = _import_bn(reader, f"{scope}/conv1d_1")
    bn2_p, bn2_s = _import_bn(reader, f"{scope}/conv1d_2")
    params = {
        "banks": {"kernels": kernels, "bn": banks_bn_p},
        "conv1d_1": {"kernel": _get(reader, f"{scope}/conv1d_1/conv1d/kernel")},
        "bn1": bn1_p,
        "conv1d_2": {"kernel": _get(reader, f"{scope}/conv1d_2/conv1d/kernel")},
        "bn2": bn2_p,
        "highway": [{"dense1": _import_dense(reader, f"{scope}/highwaynet_{i}/dense1"),
                     "dense2": _import_dense(reader, f"{scope}/highwaynet_{i}/dense2")}
                    for i in range(num_highway)],
        "gru": {"fw": _import_gru_dir(reader, f"{scope}/gru/bidirectional_rnn/fw"),
                "bw": _import_gru_dir(reader, f"{scope}/gru/bidirectional_rnn/bw")},
    }
    state = {"banks": {"bn": banks_bn_s}, "bn1": bn1_s, "bn2": bn2_s}
    return params, state


def _import_stack(reader, scope, num_banks, num_highway):
    """prenet + CBHG + y_logits under one scope (encoder, or decoder/step{1,2})."""
    cbhg_params, cbhg_state = _import_cbhg(reader, f"{scope}/CBHG", num_banks, num_highway)
    params = {"prenet": {"dense1": _import_dense(reader, f"{scope}/prenet/dense1"),
                         "dense2": _import_dense(reader, f"{scope}/prenet/dense2")},
              "CBHG": cbhg_params,
              "y_logits": _import_dense(reader, f"{scope}/y_logits")}
    return params, {"CBHG": cbhg_state}


def load_tf_encoder(ckpt_path: str, cfg):
    """enc_*_ckpt/encoder-<step> -> (params, state) trees of the encoder."""
    return _import_stack(BundleReader(ckpt_path), "encoder", cfg.num_conv_banks,
                         cfg.num_highwaynet_blocks)


def load_tf_decoder(ckpt_path: str, cfg):
    """dec_ckpt/decoder-<step> -> (params, state) trees of the decoder."""
    reader = BundleReader(ckpt_path)
    s1_params, s1_state = _import_stack(reader, "decoder/step1", cfg.step1.num_conv_banks,
                                        cfg.step1.num_highwaynet_blocks)
    s2_params, s2_state = _import_stack(reader, "decoder/step2", cfg.step2.num_conv_banks,
                                        cfg.step2.num_highwaynet_blocks)
    return {"step1": s1_params, "step2": s2_params}, {"step1": s1_state, "step2": s2_state}


def load_tf_scalars(ckpt_path: str, scope: str = "opt") -> dict:
    """Optimizer-adjacent scalars (global_step, epoch, learning rates) where present."""
    reader = BundleReader(ckpt_path)
    return {name: reader.get_tensor(f"{scope}/{name}")
            for name in ("global_step", "epoch", "learning_rate", "learning_rate_start",
                         "learning_rate_decay")
            if reader.has_tensor(f"{scope}/{name}")}
