"""The system under test: the port's `ClonePipeline` built from a
configuration file and the benchmark's weight trees.

The port is imported here, when a cell runs, and nowhere at module level.
"""

from __future__ import annotations

import torch

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def pipeline(config: dict, trees, device, **vocoder):
    """A `ClonePipeline` on ``device`` with the trees' weights; ``vocoder``
    overrides the configuration's Griffin-Lim settings."""
    from speech_cloner_tpu_torch.models import decoder as dec_m
    from speech_cloner_tpu_torch.models import encoder as enc_m
    from speech_cloner_tpu_torch.pipeline.clone import ClonePipeline
    from speech_cloner_tpu_torch.runtime.config import feature_config_from_cfg_d

    enc_cfg = enc_m.config_from_cfg_d(config["encoder"])
    dec_cfg = dec_m.config_from_cfg_d(config["decoder"])
    voc = dict(config["vocoder"], **vocoder)
    (ep, es), (dp, ds) = trees
    return ClonePipeline(
        enc_cfg=enc_cfg, dec_cfg=dec_cfg, feat_cfg=feature_config_from_cfg_d(config["features"]),
        encoder=enc_m.Encoder(ep, es, enc_cfg).to(device).eval(),
        decoder=dec_m.Decoder(dp, ds, dec_cfg).to(device).eval(),
        device=torch.device(device), n_iter=voc["n_iter"], realse=voc["realse"],
        gl_momentum=voc["gl_momentum"], gl_unroll=voc.get("gl_unroll", 1), gl_dft=voc["gl_dft"],
        mean_abs_amp_norm=voc["mean_abs_amp_norm"],
        compute_dtype=DTYPES[config["compute_dtype"]])


def model_modules(pipe) -> list[torch.nn.Module]:
    """Every model the pipeline runs (the compute-type copies and the float32
    ones), each once."""
    seen = {}
    for m in (*pipe._models, pipe.encoder, pipe.decoder):
        seen[id(m)] = m
    return list(seen.values())


def instrument_banks(pipe, spans) -> None:
    """Span "banks" from each bank convolution's packed weight to its batch
    norm: the convolution alone, on every path (the windowed forward calls
    the bank module, the sequence-parallel one its weight and norm)."""
    for model in model_modules(pipe):
        for banks in [m for m in model.modules() if type(m).__name__ == "Conv1dBanks"]:
            inner = banks.weight

            def weight(inner=inner, key=id(banks)):
                spans.start(key)
                return inner()

            def norm_pre(mod, args, key=id(banks)):
                spans.stop(key, "banks")
            object.__setattr__(banks, "weight", weight)
            banks.bn.register_forward_pre_hook(norm_pre)
