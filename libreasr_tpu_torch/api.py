"""Inference API: bundle or config -> model -> transcribe.

    bundle = ASRBundle.from_bundle("model.tar.gz")       # on cuda
    text, metrics = bundle.transcribe(pcm)              # [S] float32
    texts, metrics = bundle.transcribe_batch(audio, sample_lengths)
    texts, scores = bundle.transcribe_beam(audio, lengths, beam_width=4,
                                           use_lm=True, lm_beta=0.6)
    bundle.quantize().save("model-int8.tar.gz")         # int8 towers
    for tokens, new_text, reset in bundle.transcribe_stream(chunks): ...

The port of the JAX package's api.py, offline and streaming: greedy
decoding, beam search, and both LM fusions with the bundle's LM. It
loads every bundle kind the JAX package writes: char and BPE
tokenizers, float32 and int8-quantized towers, with or without an LM.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .checkpoint import (load_bundle, msgpack_restore, read_bundle_conf,
                         save_bundle)
from .config import parse_and_apply_config
from .convert import (export_lm_variables, export_variables,
                      load_jax_lm_variables, load_jax_variables)
from .data.language import get_language
from .models.beam import beam_decode
from .models.decode import DecoderFns, greedy_decode
from .models.lm import LM, LMConfig
from .models.transducer import Transducer, TransducerConfig
from .ops.frontend import FrontendConfig, features_batch
from .ops.quant import quantize_rnn_cells


class ASRBundle:
    """A model, its tokenizer, its frontend and, when it has one, its LM,
    on one device."""

    def __init__(self, conf: dict, model: Transducer, lang, device,
                 lm: LM | None = None):
        self.conf = conf
        self.model = model.eval().requires_grad_(False)
        self.lang = lang
        self.device = device
        self.lm = None if lm is None else lm.eval().requires_grad_(False)
        self.cfg: TransducerConfig = model.cfg
        self.frontend = FrontendConfig.from_config(conf)
        # one-slot streaming engines of transcribe_stream, by config
        self._stream_engines: dict = {}

    @classmethod
    def from_config(cls, conf: dict | None = None, *, lang_name: str = "",
                    seed: int = 0, device=None) -> "ASRBundle":
        """A seeded random model from a config (default: base.yaml); a
        config with "quantized_cells" gets those weights quantized. As
        in JAX, an LM (seed + 1) is built only when the config's `lm`
        block is enabled and names a path."""
        device = resolve_device(device)
        conf = conf or parse_and_apply_config(inference=True, lang=lang_name)
        tok = conf.get("tokenizer", {})
        lang, _ = get_language(
            model_file=tok.get("model_file") if tok.get("use_bpe") else None
        )
        cfg = TransducerConfig.from_config(conf)
        model = Transducer(dataclasses.replace(cfg, quantized_cells=False),
                           seed=seed, device=device)
        lm = None
        if conf.get("lm", {}).get("enable") and conf.get("lm", {}).get("path"):
            lm = LM(LMConfig.from_config(conf), seed=seed + 1, device=device)
        bundle = cls(conf, model, lang, device, lm)
        return bundle.quantize() if cfg.quantized_cells else bundle

    @classmethod
    def from_bundle(cls, path: str, *, lang_name: str = "en",
                    extract_to: str = "./tmp", device=None) -> "ASRBundle":
        """Load a release tar.gz bundle written by the JAX package or by
        `save`. A config with "quantized_cells" builds int8 cells. A
        bundle with an lm.msgpack gets its LM, sized by the config's `lm`
        block, whatever `lm.enable` says (as in JAX)."""
        device = resolve_device(device)
        conf = read_bundle_conf(path, lang_name) or parse_and_apply_config(
            inference=True, lang=lang_name
        )
        variables, tok, lm_bytes, _ = load_bundle(path, lang_name,
                                                  extract_to=extract_to)
        lang, _ = get_language(model_file=tok)
        model = Transducer(TransducerConfig.from_config(conf))
        load_jax_variables(model, variables)
        lm = None
        if lm_bytes:
            lm = LM(LMConfig.from_config(conf))
            load_jax_lm_variables(lm, msgpack_restore(lm_bytes))
            lm = lm.to(device)
        return cls(conf, model.to(device), lang, device, lm)

    def quantize(self) -> "ASRBundle":
        """int8-quantize the RNN towers in place: every cell matrix of
        the encoder and predictor (ops.quant.quantize_rnn_cells), marked
        by conf["quantized_cells"] so that `save` round-trips it.
        Biases, h0, norms, projections, the embedding and the LM stay
        float32."""
        variables = quantize_rnn_cells(export_variables(self.model))
        self.conf["quantized_cells"] = True
        model = Transducer(dataclasses.replace(self.cfg, quantized_cells=True))
        load_jax_variables(model, variables)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.cfg = model.cfg
        self._stream_engines.clear()  # they hold the float model
        return self

    def save(self, path: str, *, lang_name: str = "en",
             tokenizer_file: str | None = None) -> str:
        """Write this bundle as a release tar.gz in the JAX package's
        layout (its from_bundle loads it), the LM as lm.msgpack; the
        tokenizer defaults to the one this bundle was loaded with."""
        tok = tokenizer_file or getattr(self.lang, "model_file", None)
        lm_vars = None if self.lm is None else export_lm_variables(self.lm)
        return save_bundle(path, lang_name, export_variables(self.model),
                           self.conf, tokenizer_file=tok, lm_variables=lm_vars)

    def decoder_fns(self, use_lm: bool = False,
                    quantized: bool = False) -> DecoderFns:
        """Decode endpoints. use_lm binds the LM, when the bundle has one
        (as in JAX, a bundle without an LM decodes without); quantized
        runs the joint as int8 products, its weights quantized now
        (Joint.int8_step)."""
        joint = self.model.joint.int8_step() if quantized else self.model.joint_step
        if not (use_lm and self.lm is not None):
            return DecoderFns(predict_step=self.model.predict, joint_step=joint)
        return DecoderFns(predict_step=self.model.predict, joint_step=joint,
                          lm_step=self.lm, lm_init_state=self.lm.init_state)

    def encode(self, feats, lengths=None, state=None):
        """feats [N, T, F] -> (enc_out [N, T, H], per-layer states)."""
        with torch.inference_mode():
            return self.model.encode(feats, state=state, lengths=lengths)

    def transcribe_batch(self, audio, sample_lengths, *, use_lm: bool = False,
                         max_iters: int = 3, max_tokens: int = 256):
        """audio: [N, S] float32 (or int16) pcm at the config's rate;
        sample_lengths: [N]. use_lm: greedy LM fusion (alpha 0.1) with
        the bundle's LM. Returns (texts, metrics)."""
        toks, tok_lens, metrics = self.decode_tokens(
            audio, sample_lengths, use_lm=use_lm, max_iters=max_iters,
            max_tokens=max_tokens)
        return self._texts(toks, tok_lens), metrics

    def _texts(self, toks, lens) -> list[str]:
        return [self.lang.denumericalize(list(toks[i, : lens[i]]))
                for i in range(len(toks))]

    def _encode_audio(self, audio, sample_lengths):
        """pcm [N, S] -> (enc_out [N, T, H], frame lengths [N]) on the
        bundle's device: the frontend, then the encoder (kernel B, or C
        for int8 cells, from 16 stacked frames on)."""
        audio = torch.as_tensor(np.asarray(audio)).to(self.device)
        lengths = torch.as_tensor(np.asarray(sample_lengths)).to(self.device)
        feats, flens = features_batch(audio, lengths, self.frontend)
        enc_out, _ = self.model.encode(feats, lengths=flens)
        return enc_out, flens

    def decode_tokens(self, audio, sample_lengths, *, use_lm: bool = False,
                      max_iters: int = 3, max_tokens: int = 256):
        """Frontend -> encoder -> greedy decode. Returns numpy
        (tokens [N, max_tokens], token counts [N], metrics)."""
        with torch.inference_mode():
            enc_out, flens = self._encode_audio(audio, sample_lengths)
            toks, tok_lens, metrics, _ = greedy_decode(
                self.decoder_fns(use_lm=use_lm), enc_out, flens,
                vocab_sz=self.cfg.vocab_sz, blank=self.cfg.blank,
                bos=self.cfg.bos, max_iters=max_iters, max_tokens=max_tokens,
            )
        return (toks.cpu().numpy(), tok_lens.cpu().numpy(),
                {k: v.cpu().numpy() for k, v in metrics.items()})

    def beam_tokens(self, audio, sample_lengths, *, beam_width: int = 4,
                    use_lm: bool = False, max_expand: int = 3,
                    max_tokens: int = 256, lm_alpha: float = 0.1,
                    lm_beta: float = 0.0):
        """Frontend -> encoder -> beam search. Returns numpy (tokens [N,
        max_tokens], token counts [N], scores [N]) of each stream's best
        beam."""
        with torch.inference_mode():
            enc_out, flens = self._encode_audio(audio, sample_lengths)
            toks, lens, scores = beam_decode(
                self.decoder_fns(use_lm=use_lm), enc_out, flens,
                vocab_sz=self.cfg.vocab_sz, beam_width=beam_width,
                blank=self.cfg.blank, bos=self.cfg.bos, max_expand=max_expand,
                max_tokens=max_tokens, lm_alpha=lm_alpha, lm_beta=lm_beta,
            )
        return toks.cpu().numpy(), lens.cpu().numpy(), scores.cpu().numpy()

    def transcribe_beam(self, audio, sample_lengths=None, *,
                        beam_width: int = 4, use_lm: bool = False,
                        max_expand: int = 3, max_tokens: int = 256,
                        lm_alpha: float = 0.1, lm_beta: float = 0.0):
        """Beam-search transcription, with log-linear LM fusion when
        use_lm (lm_beta: the token insertion bonus). audio: [S] or [N,
        S]; sample_lengths default to the full width. Returns (texts,
        scores), or (text, score) for one [S] input."""
        audio = np.asarray(audio)
        single = audio.ndim == 1
        if single:
            audio = audio[None]
        if sample_lengths is None:
            sample_lengths = np.full(len(audio), audio.shape[1])
        toks, lens, scores = self.beam_tokens(
            audio, sample_lengths, beam_width=beam_width, use_lm=use_lm,
            max_expand=max_expand, max_tokens=max_tokens, lm_alpha=lm_alpha,
            lm_beta=lm_beta)
        texts = self._texts(toks, lens)
        if single:
            return texts[0], float(scores[0])
        return texts, scores

    def transcribe(self, audio, **kw):
        """One utterance [S] -> (text, metrics)."""
        audio = np.asarray(audio, np.float32).reshape(1, -1)
        texts, metrics = self.transcribe_batch(
            audio, np.array([audio.shape[1]]), **kw
        )
        return texts[0], {k: v[0] for k, v in metrics.items()}

    def transcribe_stream(self, chunks, *, use_lm: bool = False, **scfg_kw):
        """Generator over a chunk iterable: yields (all_tokens, new_text,
        reset_fn) per fed chunk. A thin wrapper over a one-slot
        StreamingEngine, cached per config, so repeated calls reuse its
        step (its CUDA graph on the card); for many concurrent streams
        use StreamingEngine directly."""
        from .models.streaming import StreamingConfig, StreamingEngine

        key = (use_lm, tuple(sorted(scfg_kw.items())))
        engine = self._stream_engines.get(key)
        if engine is None:
            scfg = StreamingConfig(sr=self.frontend.sr, **scfg_kw)
            engine = StreamingEngine(self, n_streams=1, scfg=scfg,
                                     use_lm=use_lm)
            self._stream_engines[key] = engine
        slot = engine.open_slot()

        def reset_fn():
            engine._pending_reset_arr[slot] = True
            engine.emitted[slot] = []

        try:
            for chunk in chunks:
                if chunk is None:
                    continue
                new_text = engine.feed(
                    slot, np.asarray(chunk, np.float32).reshape(-1))
                yield list(engine.emitted[slot]), new_text, reset_fn
        finally:
            engine.close_slot(slot)
