"""Long-document encode through ``SentenceEncoder.encode``: batches of
synthetic documents (``packed=False``, the long buckets), a closed loop of
one caller encoding one batch at a time into unit embeddings on the card.

The check: a sample of the encoded documents drawn by the seed; the
reference tokenizes each from its text and embeds it in f32 (weights made
again from the seed); ``cos_gap`` is the widest 1 − cosine between a
returned embedding and the reference's, a non-finite embedding reading 2.

Variant ``int8`` (the control): the program's int8 encoder (``to_int8``)."""

from __future__ import annotations

import numpy as np
import torch

from .. import flops, gen, trace, weights
from . import Window, closed_loop, cuda_sync, keep_sample

FLASH_FWD = ("flash_fwd_bf16",)


class Cell:
    unit = "batch"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device="cuda", variant=None):
        self.cfg, self.t, self.seed, self.device = cfg, traffic, int(seed), torch.device(device)
        self.variant = variant
        self.fields = weights.arch_fields(cfg)
        self.sync = cuda_sync(self.device)
        self.kept = {}

    def setup(self) -> None:
        from text_similarity_tpu_torch.core.config import EncoderArch
        from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer
        from text_similarity_tpu_torch.models import SentenceEncoder

        t = self.t
        n = t["batches"] * t["docs_per_batch"]
        docs, lens = gen.documents(n, *t["doc_tokens"], gen.rng_for(self.seed, 1))
        self.lens = np.minimum(lens, t["max_len"])
        self.batches = [list(range(b * t["docs_per_batch"], (b + 1) * t["docs_per_batch"]))
                        for b in range(t["batches"])]
        self.docs = docs
        self.order = gen.rng_for(self.seed, 3).permutation(t["batches"])
        tok = WordPieceTokenizer.from_vocab_file(gen.VOCAB)
        arch = EncoderArch(**self.fields)
        params = weights.make_params(self.fields, gen.torch_seed(self.seed, 0), self.device)
        self.enc = SentenceEncoder(params, arch, tokenizer=tok, device=self.device)
        if self.variant == "int8":
            self.enc = self.enc.to_int8()
        self._encode(0)                          # every batch has one shape
        self.sync()

    def _encode(self, b: int):
        t = self.t
        texts = [self.docs[j] for j in self.batches[b]]
        with trace.span("encoder.encode"):
            return self.enc.encode(texts, batch_size=t["docs_per_batch"], max_len=t["max_len"],
                                   buckets=tuple(t["buckets"]), packed=False,
                                   device_output=True)

    def _request(self, i: int) -> float:
        b = int(self.order[i % len(self.order)])
        emb = self._encode(b)
        if keep_sample(self.seed, i, self.t["keep_every"]):
            self.kept[i] = (b, emb)
        return float(self.lens[self.batches[b]].sum())

    def window(self, seconds: float) -> Window:
        win = closed_loop(seconds, self._request, self.sync)
        self.window_batches = [int(self.order[i % len(self.order)]) for i in win.tags]
        return win

    def traced(self) -> int:
        n = self.t["trace_batches"]
        self.traced_batches = [int(self.order[i % len(self.order)]) for i in range(n)]
        for b in self.traced_batches:
            self._encode(b)
        return n

    def e2e(self, win: Window) -> dict:
        return {"encode_tokens_per_s": win.rate()}

    def layer_ctx(self, win: Window, reading) -> dict:
        f = self.fields
        nh, hd = f["num_heads"], f["hidden_size"] // f["num_heads"]
        w, cls = f["attention_window"], f["window_global_cls"]
        non_emb = weights.non_embedding_params(f)
        width = self.t["buckets"][-1]
        useful = sum(flops.encoder_flops(non_emb, self.lens[self.batches[b]], f["num_layers"],
                                         f["hidden_size"], w, cls) for b in self.window_batches)
        fwd = [flops.flash_fwd(len(self.batches[b]), width, nh, hd, self.lens[self.batches[b]],
                               w, cls) for b in self.traced_batches] * f["num_layers"]
        return {"window": win, "reading": reading, "useful_flops": useful,
                "flash_fwd_work": fwd, "flash_fwd_kernels": FLASH_FWD}

    def free(self) -> None:
        self.enc = None

    def check(self) -> dict:
        from ..reference import encoder as E

        E.no_tf32()
        rng = gen.rng_for(self.seed, 4)
        reqs = sorted(self.kept)
        p = weights.make_params(self.fields, gen.torch_seed(self.seed, 0), self.device)
        tok = gen.tokenizer()
        gap = 0.0
        for _ in range(self.t["check_docs"]):
            b, emb = self.kept[reqs[int(rng.integers(len(reqs)))]]
            j = int(rng.integers(len(self.batches[b])))
            if emb.shape[0] != len(self.batches[b]) or not bool(torch.isfinite(emb[j]).all()):
                gap = max(gap, 2.0)
                continue
            ids, mask = tok.batch([self.docs[self.batches[b][j]]], self.t["max_len"])
            ref = E.embed_rows(p, self.fields, torch.as_tensor(ids, device=self.device),
                               torch.as_tensor(mask, device=self.device))[0]
            got = emb[j].float()
            cos = float(got @ ref / got.norm().clamp_min(1e-12))
            gap = max(gap, 1.0 - cos)
        return {"cos_gap": gap}
