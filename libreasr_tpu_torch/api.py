"""Inference API: bundle or config -> model -> transcribe.

    bundle = ASRBundle.from_bundle("model.tar.gz")       # on cuda
    text, metrics = bundle.transcribe(pcm)              # [S] float32
    texts, metrics = bundle.transcribe_batch(audio, sample_lengths)

The port of the JAX package's api.py for the offline greedy path.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .checkpoint import load_bundle, read_bundle_conf
from .config import parse_and_apply_config
from .convert import load_jax_variables
from .data.language import get_language
from .models.decode import DecoderFns, greedy_decode
from .models.transducer import Transducer, TransducerConfig
from .ops.frontend import FrontendConfig, features_batch


class ASRBundle:
    """A model, its tokenizer and its frontend on one device."""

    def __init__(self, conf: dict, model: Transducer, lang, device):
        self.conf = conf
        self.model = model
        self.lang = lang
        self.device = device
        self.cfg: TransducerConfig = model.cfg
        self.frontend = FrontendConfig.from_config(conf)

    @classmethod
    def from_config(cls, conf: dict | None = None, *, lang_name: str = "",
                    seed: int = 0, device=None) -> "ASRBundle":
        """A seeded random model from a config (default: base.yaml)."""
        device = resolve_device(device)
        conf = conf or parse_and_apply_config(inference=True, lang=lang_name)
        tok = conf.get("tokenizer", {})
        lang, _ = get_language(
            model_file=tok.get("model_file") if tok.get("use_bpe") else None
        )
        model = Transducer(TransducerConfig.from_config(conf), seed=seed,
                           device=device)
        return cls(conf, model, lang, device)

    @classmethod
    def from_bundle(cls, path: str, *, lang_name: str = "en",
                    extract_to: str = "./tmp", device=None) -> "ASRBundle":
        """Load a release tar.gz bundle written by the JAX package."""
        device = resolve_device(device)
        conf = read_bundle_conf(path, lang_name) or parse_and_apply_config(
            inference=True, lang=lang_name
        )
        if conf.get("quantized_cells"):
            raise NotImplementedError(
                "libreasr_tpu_torch: int8-quantized bundles are not ported yet")
        variables, tok, _, _ = load_bundle(path, lang_name, extract_to=extract_to)
        lang, _ = get_language(model_file=tok)
        model = Transducer(TransducerConfig.from_config(conf))
        load_jax_variables(model, variables)
        return cls(conf, model.to(device), lang, device)

    def decoder_fns(self) -> DecoderFns:
        return DecoderFns(predict_step=self.model.predict,
                          joint_step=self.model.joint_step)

    def encode(self, feats, lengths=None, state=None):
        """feats [N, T, F] -> (enc_out [N, T, H], per-layer states)."""
        with torch.inference_mode():
            return self.model.encode(feats, state=state, lengths=lengths)

    def transcribe_batch(self, audio, sample_lengths, *, use_lm: bool = False,
                         max_iters: int = 3, max_tokens: int = 256):
        """audio: [N, S] float32 (or int16) pcm at the config's rate;
        sample_lengths: [N]. Returns (texts, metrics)."""
        if use_lm:
            raise NotImplementedError(
                "libreasr_tpu_torch: LM fusion is not ported yet")
        toks, tok_lens, metrics = self.decode_tokens(
            audio, sample_lengths, max_iters=max_iters, max_tokens=max_tokens
        )
        texts = [self.lang.denumericalize(list(toks[i, : tok_lens[i]]))
                 for i in range(len(toks))]
        return texts, metrics

    def decode_tokens(self, audio, sample_lengths, *, max_iters: int = 3,
                      max_tokens: int = 256):
        """Frontend -> encoder -> greedy decode. Returns numpy
        (tokens [N, max_tokens], token counts [N], metrics)."""
        audio = torch.as_tensor(np.asarray(audio)).to(self.device)
        lengths = torch.as_tensor(np.asarray(sample_lengths)).to(self.device)
        with torch.inference_mode():
            feats, flens = features_batch(audio, lengths, self.frontend)
            enc_out, _ = self.model.encode(feats, lengths=flens)
            toks, tok_lens, metrics, _ = greedy_decode(
                self.decoder_fns(), enc_out, flens, blank=self.cfg.blank,
                bos=self.cfg.bos, max_iters=max_iters, max_tokens=max_tokens,
            )
        return (toks.cpu().numpy(), tok_lens.cpu().numpy(),
                {k: v.cpu().numpy() for k, v in metrics.items()})

    def transcribe(self, audio, **kw):
        """One utterance [S] -> (text, metrics)."""
        audio = np.asarray(audio, np.float32).reshape(1, -1)
        texts, metrics = self.transcribe_batch(
            audio, np.array([audio.shape[1]]), **kw
        )
        return texts[0], {k: v[0] for k, v in metrics.items()}
