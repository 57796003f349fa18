"""Import a release of the reference LibreASR into a servable bundle.

Takes the reference's release artifact, a tar.gz of `{lang}/model.pth`
(a fastai/torch checkpoint) and `{lang}/tokenizer.yttm-model`
(youtokentome BPE), and writes a bundle in the JAX package's layout,
which the port's ASRBundle.from_bundle and the JAX package's both load:

    python -m libreasr_tpu_torch.scripts.import_reference \\
        --archive libreasr-model-en.tar.gz [--lang en] \\
        [--out tmp/imported/model.tar.gz] [--config config/base.yaml] \\
        [--check] [--device cuda|cpu]

The model's shape (layers, hidden, vocab, joint) is inferred from the
checkpoint's tensor shapes; --config only seeds the serving defaults.
The weights go through compat/torch_import.py into a port model on
--device (the card unless `--device cpu`), which checks every tensor's
shape; the tokenizer through compat/yttm_import.py. --check reloads the
bundle and decodes one second of silence.
"""

from __future__ import annotations

import argparse
import os
import tarfile
import tempfile


def infer_model_conf(sd: dict) -> dict:
    """Reference Transducer state_dict -> conf['model'], from tensor
    shapes alone (the JAX script's rules)."""
    import numpy as np

    def shape(k):
        return tuple(np.asarray(sd[k]).shape)

    feature_sz = shape("encoder.input_norm.weight")[0]
    enc_layers = len({k.split(".")[3] for k in sd
                      if k.startswith("encoder.rnn_stack.rnns.")})
    pred_layers = len({k.split(".")[3] for k in sd
                       if k.startswith("predictor.rnn_stack.rnns.")})
    if "encoder.rnn_stack.rnns.0.weight_hh_l0" in sd:
        enc_type = "LSTM"
        hidden_sz = shape("encoder.rnn_stack.rnns.0.weight_hh_l0")[1]
    else:
        enc_type = "NBRC"
        hidden_sz = shape("encoder.rnn_stack.rnns.0.recurrent_kernel")[0]
    pred_type = ("LSTM" if "predictor.rnn_stack.rnns.0.weight_hh_l0" in sd
                 else "NBRC")
    vocab_sz, embed_sz = shape("predictor.embed.weight")
    out_sz = (shape("encoder.linear.weight")[0]
              if "encoder.linear.weight" in sd else hidden_sz)
    joint_sz = shape("joint.joint.0.weight")[0]
    has_bn = "encoder.rnn_stack.bns.0.weight" in sd
    return {
        "feature_sz": feature_sz,
        "embed_sz": embed_sz,
        "vocab_sz": vocab_sz,
        "hidden_sz": hidden_sz,
        "out_sz": out_sz,
        "joint_sz": joint_sz,
        "joint": {"method": "concat"},
        "encoder": {
            "num_layers": enc_layers, "dropout": 0.0, "rnn_type": enc_type,
            "norm": "batch" if has_bn else "none",
        },
        "predictor": {
            "num_layers": pred_layers, "dropout": 0.0, "rnn_type": pred_type,
            "norm": ("batch" if "predictor.rnn_stack.bns.0.weight" in sd
                     else "none"),
        },
    }


def _labpe_vocab(path: str) -> int:
    with open(path, encoding="utf-8") as f:
        if f.readline().strip() != "LABPE1":
            raise ValueError(f"{path} is not a LABPE1 model")
        return int(f.readline())


def _reconcile_frontend(conf: dict, feat: int) -> None:
    """Make the frontend produce `feat`-dim features: features are
    n_mels * (1 + deltas) * n_stack. The reference's release frontend is
    128 mels x 10 stacked = 1280, so real artifacts pass untouched;
    otherwise keep the configured mel count when it divides, else take
    `feat` mels unstacked, and say so."""
    from ..ops.frontend import FrontendConfig

    fcfg = FrontendConfig.from_config(conf)
    if fcfg.feature_sz == feat:
        return
    per_frame = fcfg.n_mels * (1 + fcfg.deltas)
    stages = conf.setdefault("transforms", {}).setdefault("features", [])
    st = next((s for s in stages
               if (s or {}).get("name") == "StackDownsample"), None)
    if st is None:
        st = {"name": "StackDownsample",
              "args": {"downsample": fcfg.downsample, "n_stack": fcfg.n_stack}}
        stages.append(st)
    if feat % per_frame == 0:
        st.setdefault("args", {})["n_stack"] = feat // per_frame
    else:
        conf.setdefault("melkwargs", {})["n_mels"] = feat
        conf["deltas"] = 0
        st.setdefault("args", {})["n_stack"] = 1
    if FrontendConfig.from_config(conf).feature_sz != feat:
        raise ValueError(f"cannot make the frontend produce {feat}-dim features")
    print(f"[import] WARNING: frontend adjusted to produce "
          f"{feat}-dim features (config gave {fcfg.feature_sz}); "
          "verify it matches the checkpoint's training frontend")


def import_reference_archive(archive: str, lang: str, out: str,
                             base_config: str | None = None,
                             device=None) -> str:
    """Write the bundle of a reference release archive to `out`. The
    weights are loaded into a port model on `device` (default cuda;
    raises without it) before they are written."""
    from .. import resolve_device
    from ..checkpoint import save_bundle
    from ..compat.torch_import import convert_transducer, load_torch_state_dict
    from ..compat.yttm_import import convert_yttm_model
    from ..config import open_config
    from ..convert import export_variables, load_jax_variables
    from ..models.transducer import Transducer, TransducerConfig

    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        with tarfile.open(archive, "r:gz") as tar:
            tar.extractall(tmp, filter="data")
        d = os.path.join(tmp, lang)
        pth = os.path.join(d, "model.pth")
        yttm = os.path.join(d, "tokenizer.yttm-model")
        if not os.path.exists(pth):
            raise SystemExit(f"{archive} has no {lang}/model.pth "
                             f"(reference bundle layout, model_utils.py:30-47)")
        tok_out = os.path.join(tmp, "tokenizer.labpe-model")
        tok_file = None
        if os.path.exists(yttm):
            vocab = convert_yttm_model(yttm, tok_out)
            tok_file = tok_out
            print(f"[import] tokenizer: yttm -> LABPE1, vocab {vocab}")
        else:
            print(f"[import] WARNING: no {lang}/tokenizer.yttm-model — "
                  "bundle will fall back to the char-level language")

        sd = load_torch_state_dict(pth)
        mconf = infer_model_conf(sd)
        print(f"[import] inferred shape: enc {mconf['encoder']['num_layers']}x"
              f"{mconf['encoder']['rnn_type']} h={mconf['hidden_sz']}, "
              f"pred {mconf['predictor']['num_layers']}x"
              f"{mconf['predictor']['rnn_type']}, vocab {mconf['vocab_sz']}, "
              f"joint {mconf['joint_sz']}")
        if tok_file:
            tok_vocab = _labpe_vocab(tok_file)
            if tok_vocab != mconf["vocab_sz"]:
                raise SystemExit(
                    f"tokenizer vocab {tok_vocab} != model vocab "
                    f"{mconf['vocab_sz']} — mismatched artifact")

        conf: dict = open_config(base_config) if base_config else {}
        conf["model"] = {**conf.get("model", {}), **mconf}
        # the base config's nested model keys must not override the
        # inferred shape
        for k in ("encoder", "predictor", "joint"):
            base = (conf.get("model") or {}).get(k) or {}
            conf["model"][k] = {**base, **mconf[k]}
        conf.setdefault("tokenizer", {})["use_bpe"] = tok_file is not None
        conf["imported_from"] = os.path.basename(archive)
        _reconcile_frontend(conf, mconf["feature_sz"])

        cfg = TransducerConfig.from_config(conf)
        model = Transducer(cfg, device=device)
        load_jax_variables(model, convert_transducer(sd, cfg))
        save_bundle(out, lang, export_variables(model), conf,
                    tokenizer_file=tok_file)
    print(f"[import] bundle -> {out}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--archive", required=True,
                   help="reference libreasr-model-*.tar.gz")
    p.add_argument("--lang", default="en")
    p.add_argument("--out", default="tmp/imported/model.tar.gz")
    p.add_argument("--config", default="config/base.yaml",
                   help="base config for non-shape serving defaults")
    p.add_argument("--check", action="store_true",
                   help="load the written bundle and greedy-decode 1 s of "
                        "silence")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    out = import_reference_archive(a.archive, a.lang, a.out,
                                   base_config=a.config, device=a.device)
    if a.check:
        import numpy as np

        from ..api import ASRBundle

        bundle = ASRBundle.from_bundle(out, lang_name=a.lang,
                                       extract_to="tmp/imported_check",
                                       device=a.device)
        text, _ = bundle.transcribe(np.zeros(bundle.frontend.sr, np.float32))
        print(f"[import] smoke decode (1 s silence): {text!r}")
    return out


if __name__ == "__main__":
    main()
