"""Inference API: bundle or config -> model -> transcribe.

    bundle = ASRBundle.from_bundle("model.tar.gz")       # on cuda
    text, metrics = bundle.transcribe(pcm)              # [S] float32
    texts, metrics = bundle.transcribe_batch(audio, sample_lengths)
    bundle.quantize().save("model-int8.tar.gz")         # int8 towers

The port of the JAX package's api.py for the offline greedy path. It
loads every bundle kind the JAX package writes for greedy serving:
char and BPE tokenizers, float32 and int8-quantized towers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .checkpoint import load_bundle, read_bundle_conf, save_bundle
from .config import parse_and_apply_config
from .convert import export_variables, load_jax_variables
from .data.language import get_language
from .models.decode import DecoderFns, greedy_decode
from .models.transducer import Transducer, TransducerConfig
from .ops.frontend import FrontendConfig, features_batch
from .ops.quant import quantize_rnn_cells


class ASRBundle:
    """A model, its tokenizer and its frontend on one device."""

    def __init__(self, conf: dict, model: Transducer, lang, device):
        self.conf = conf
        self.model = model.eval().requires_grad_(False)
        self.lang = lang
        self.device = device
        self.cfg: TransducerConfig = model.cfg
        self.frontend = FrontendConfig.from_config(conf)

    @classmethod
    def from_config(cls, conf: dict | None = None, *, lang_name: str = "",
                    seed: int = 0, device=None) -> "ASRBundle":
        """A seeded random model from a config (default: base.yaml); a
        config with "quantized_cells" gets those weights quantized."""
        device = resolve_device(device)
        conf = conf or parse_and_apply_config(inference=True, lang=lang_name)
        tok = conf.get("tokenizer", {})
        lang, _ = get_language(
            model_file=tok.get("model_file") if tok.get("use_bpe") else None
        )
        cfg = TransducerConfig.from_config(conf)
        model = Transducer(dataclasses.replace(cfg, quantized_cells=False),
                           seed=seed, device=device)
        bundle = cls(conf, model, lang, device)
        return bundle.quantize() if cfg.quantized_cells else bundle

    @classmethod
    def from_bundle(cls, path: str, *, lang_name: str = "en",
                    extract_to: str = "./tmp", device=None) -> "ASRBundle":
        """Load a release tar.gz bundle written by the JAX package or by
        `save`. A config with "quantized_cells" builds int8 cells."""
        device = resolve_device(device)
        conf = read_bundle_conf(path, lang_name) or parse_and_apply_config(
            inference=True, lang=lang_name
        )
        variables, tok, _, _ = load_bundle(path, lang_name, extract_to=extract_to)
        lang, _ = get_language(model_file=tok)
        model = Transducer(TransducerConfig.from_config(conf))
        load_jax_variables(model, variables)
        return cls(conf, model.to(device), lang, device)

    def quantize(self) -> "ASRBundle":
        """int8-quantize the RNN towers in place: every cell matrix of
        the encoder and predictor (ops.quant.quantize_rnn_cells), marked
        by conf["quantized_cells"] so that `save` round-trips it.
        Biases, h0, norms, projections and the embedding stay float32."""
        variables = quantize_rnn_cells(export_variables(self.model))
        self.conf["quantized_cells"] = True
        model = Transducer(dataclasses.replace(self.cfg, quantized_cells=True))
        load_jax_variables(model, variables)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.cfg = model.cfg
        return self

    def save(self, path: str, *, lang_name: str = "en",
             tokenizer_file: str | None = None) -> str:
        """Write this bundle as a release tar.gz in the JAX package's
        layout (its from_bundle loads it); the tokenizer defaults to the
        one this bundle was loaded with."""
        tok = tokenizer_file or getattr(self.lang, "model_file", None)
        return save_bundle(path, lang_name, export_variables(self.model),
                           self.conf, tokenizer_file=tok)

    def decoder_fns(self, quantized: bool = False) -> DecoderFns:
        """Decode endpoints; quantized=True runs the joint as int8
        products, its weights quantized now (Joint.int8_step)."""
        joint = self.model.joint.int8_step() if quantized else self.model.joint_step
        return DecoderFns(predict_step=self.model.predict, joint_step=joint)

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
