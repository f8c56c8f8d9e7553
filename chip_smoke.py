#!/usr/bin/env python3
"""Run the PyTorch port's semantic-search, long-document, training,
packed-encode, serving, training-entry-point, command-line, compression /
clustering / word-model, MoE / Performer, distributed serving and
distributed training paths on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
 1. the card: ``nvidia-smi`` name and power limit; build the CUDA kernels
    from ``text_similarity_tpu_torch/csrc`` (nvcc, sm_90a; one process per
    source, started together).
 2. K2 (exact cosine top-k) against its plain version at N = 100,003 ragged,
    D = 384, Q ∈ {1, 7, 256}, k ∈ {10, 20}, f32 and bf16 corpora with
    duplicated rows; timed at Q 1, 8 and 64 (the pipeline's padded request
    sizes) and 256, each beside ``torch.topk(q @ cᵀ)`` and its bound.
    Then the large-k route (``csrc/topk_select.cu``): K2 (f32, bf16) and K3
    (int8) at k ∈ {300, 1000, 4096} on the same Q 256 × N 100,003 corpus
    against their plain versions (f32 and int8 ids equal where the scores
    are separated, bf16 overlap ≥ 0.99), f32 at k 300 bit-equal to the
    selector at k 256 on its first 256, each timed beside ``torch.topk(q @
    cᵀ, k)`` and its bound.
 2b. K8 (certified two-pass top-k) through ``cosine_topk_2pass`` at phase
    2's shapes (f32 and bf16, Q ∈ {1, 7, 256}, k ∈ {10, 20}) and at Q 1024,
    k 10, with its counters zeroed just before: pass A launches on every
    call, pass B over pass A's kept scores on the phase-2 shapes and on the
    score tile at Q 1024 (scores over 256 MiB); each call against the plain
    version (f32 ids equal where scores are separated, |Δ| ≤ 1e-5; bf16
    overlap ≥ 0.99, |Δ| ≤ 1e-4) and against K2, falling back exactly where
    the plain version does; pass A and both pass Bs alone against their
    plain versions, pass A's kept scores equal to K2's bit for bit; a
    collision corpus (two near-copies 2048 rows apart) must fall back to K2
    once and keep both copies. Timed at Q = 256, k = 10 beside K2 and
    ``torch.topk(q @ cᵀ)``, each pass with its bound. Then the call at k
    300 (Q 256, f32; pass A's select kernel counted) and pass A alone
    against their plain versions, timed.
 3. K1 (IVF scan) against its plain version on a 1M × 384 IVF index built
    on the card from the bench recipe (4096 gaussian centres ×3 + unit
    noise; queries = corpus rows + 0.1 noise), bf16 slabs,
    ``IndexConfig.auto(1M)``, 4096 queries with the serving args at k = 10
    and k = 100 (deferred merge) and approx_width = 0 (exact merge); IVF
    recall@10 against K2's exact top-k over the f32 corpus ≥ 0.95. Then
    the exact scan at k 300 for a 256-query slice: ``IVFIndex.query``
    through the large-k route (emit_acc probe by probe, the select kernel),
    counted, and the scan held to the plain scan (overlap ≥ 0.99, |Δ| ≤
    1e-4) and timed.
 4. The pipeline at the full width of minilm-l6 (random weights from a
    seed, vocab trained on a synthetic corpus): 120,000 documents (the IVF
    path, K1) and 2,000 documents (the brute-force path, K2), requests of 1,
    5 and 64 verbatim corpus sentences; each must find itself in its top 10
    at score ≥ 0.99 (≥ 95% of queries; on a multi-query IVF request, of
    the queries whose own slab was in their block's shared probe list).
    Both kernels' launch counters must rise during this phase, every K1
    launch must run on the wgmma tile, and each kernel must agree with its
    plain version at the pipeline's shapes: K1 at a 1-, 5- and 64-text
    request (block_q 1, 8 and 64: the tile's 8- and 64-query forms).
    ``encode``'s ``packed="auto"`` packs these sentences; the corpus also
    runs with ``packed=False``: both rates, the host time of
    ``pack_sequences``, and the routes' unit embeddings (1 − min cosine
    ≤ 1.5e-5, max |Δ| ≤ 3.5e-3, the next document's embedding as the
    control); the 64-text encode on both routes.
 5. int8 serving:
    - K3 (int8 top-k) against its plain version at N = 100,003 ragged,
      D = 384, Q ∈ {1, 7, 8, 64, 256} (query tiles 16, 64 and 128), k ∈
      {10, 20}, duplicated rows (|Δscore| ≤ 1e-5, ids equal where the
      scores are separated); timed at
      Q 1, 8, 64 (the pipeline's padded request sizes) and 256, k = 10,
      each beside ``torch.topk((q @ c.float().T) * s, k)`` and its bound;
      an int8 ``BruteForceIndex`` over the same corpus at k 200 (its 2k
      over-fetch through K3's large-k route, counted: the kernels line's
      launches) against the plain version;
    - K4 (int8 IVF scan) against its plain version on an int8 index of the
      phase-3 corpus (``IndexConfig.auto(1M)``, ``quantize_int8=True``, bf16
      rescore copy), 4096 queries with the serving args: k = 10 raw, the
      rescore's k_scan = 20 (deferred, S = 2) and the exact merge; recall@10
      of int8 + rescore against K2's exact top-10 ≥ 0.95 (raw int8
      recall and both QPS printed); K4 exact at k 300 through the large-k
      route as K1 in phase 3 (``IVFIndex.query`` with its rescore: the
      scan at 600);
    - the int8 pipeline: the phase-4 minilm-l6 weights through ``to_int8``,
      the 120,000 documents with an int8 IVF (``IndexConfig.auto`` with
      ``quantize_int8=True``), requests of 1, 5 and 64 under phase 4's
      self-retrieval gate, one ``add_documents`` (the new document finds
      itself) and one ``remove_documents`` (the removed id never comes
      back) on the built index, one ``BruteForceIndex`` query over an
      ``EmbeddingStore(quantized=True)`` of 2,000 of those embeddings (its
      answer, K3 at Q 64, against the plain version under phase 5's K3
      gate). The K3 and K4 launch counters, zeroed just before, must rise,
      every K4 launch on the wgmma tile; K4 at a 1-, 5- and 64-text request
      against its plain version as K1 in phase 4. Printed:
      the mean cosine between the int8 and the bf16 encoder's embeddings of
      64 texts and the int8 encoder's sentences/s.
 5b. IVF options (the index's other layouts and scan modes), on the
    phase-3 bf16 index, the phase-5 int8 + rescore index, a ``sentinel=True``
    and a ``group=2`` bf16 build of the phase-3 corpus, 4096 queries with the
    serving args (block_q 64, union_factor 1; approx_width 2048 at k = 10,
    bench.py's 512 at k = 100): ``per_probe`` (bf16; int8 + rescore,
    k_coarse 20), ``final_merge`` xla / xla_approx at k = 100 (bf16, int8 +
    rescore), packed at k 10 and 100, ``dma_pipeline`` (buffers 2-4, k 10;
    k 100), ``probes_per_step`` 2, 3, 4, the sentinel index at k 10 (the
    idless scan) and 100 (K1 over 385-wide slabs) with one ``remove`` and one
    ``add``, the grouped index at k 10, all through ``IVFIndex.query`` with
    the launch counters zeroed just before; recall@10 (recall@100 at k =
    100) against K2's exact answer ≥ 0.95 for every option; the removed row
    never comes back, the added row finds itself; every new counter rises.
    Then each kernel against its plain version at those shapes: K1-opt
    per_probe (bf16, int8, on K1's wgmma tile: each probe's top-k pooled
    and selected equals K1's / K4's exact mode on the tile bit for bit;
    both timed) and emit_acc (bf16 k 100, int8 k_scan 200, on K1's wgmma
    tile: its entries after the exact select equal K1 on the tile at the
    same (w, S) bit for bit; both timed), K9 on the wgmma tile at k 10 and
    100 (unpacked scores within one 14-bit bin, overlap ≥ 0.99, the share
    of packets bit-equal printed; both timed), K10 (buffers 2-4 at k 10, 2 at
    k 100) and K11a (P 2, 3, 4, each timed), both on K1's wgmma tile and
    equal, bit for bit, to K1 at approx_width = Mc and to emit_acc + the
    exact select there, K11b on the wgmma tile (its counter's share of
    probed tiles skipped as all zero) and K1 on the 385-wide slabs (its
    CUDA-core kernel, bit for bit equal to that kernel's fold, emit_acc +
    top-k); f32 |Δscore| ≤ 1e-4 and overlap ≥ 0.99 elsewhere; every
    per_probe, emit_acc, K9, K10, K11a and K11b launch of the options
    window on the tile;
    times beside K1's at the same k, and each option's query rate.
 6. long documents:
    - K5 (flash attention forward) against its plain version at the
      shapes the long encodes below give it, B 8 × S 4096 × H 12 with D 64
      (roberta-base-long) and D 32 (minilm-l6), lengths 3001-4096, and at
      B 3 × S 512 × D 32 with a zero-length row; f32 and bf16; window 0,
      256 and 256 + global CLS;
      q, k, v as views of a fused QKV; outputs on valid rows (f32 max |Δ| ≤
      1e-4; bf16 max ≤ 1e-2, mean ≤ 5e-4), lse (≤ 1e-4), zero-length rows
      exactly 0. Timed at the serving shape (B 8, S 4096, H 12, D 64, bf16;
      window 256 + global CLS, and window 0) beside the plain version and
      ``scaled_dot_product_attention`` with the equivalent boolean mask;
    - roberta-base converted for long documents (random weights from a
      seed, positions tiled to 4098, window 256, global CLS, bf16) encodes
      128 documents joined from the phase-4 sentences (112 of 3000-4040
      tokens, 16 of 600-980) with ``encode(max_len=4096, buckets=… 1024,
      2048, 4096, batch_size=8, packed=False)`` into an ``EmbeddingStore`` searched by
      ``BruteForceIndex`` (K2). Gates: K5's launches in that encode = 12 ×
      the batches at bucket 4096, and K2, zeroed with it, launches in the
      search; 16 documents queried with their own text
      find themselves in the top 10 at score ≥ 0.99 (≥ 95%); one batch of 8
      documents through ``encoder_forward`` with ``attention_impl="auto"``
      (K5) and ``"reference"`` on the card: last_hidden_state on valid rows
      within ``AGREE_MEAN`` / ``AGREE_MAX``, pooled cosine ≥ 0.99, and
      another document's rows at least 10 × ``AGREE_MEAN`` away (so the
      gate can tell documents apart). Printed: docs/s, tokens/s and a
      ``torch.profiler`` split of one 8 × 4096 encode (K5, GEMMs, the rest,
      the device's idle share);
    - window 0 on the path: minilm-l6 with positions tiled to 4096 encodes
      16 long documents (K5 launches = 6 × batches at 4096; the same
      agreement gate against its reference path).
 7. training:
    - K6 (flash attention backward: dq, dk/dv) against its plain version
      on K5's o and lse and a random do (nonzero on padded rows too), B 4 ×
      S 4096 × H 12 with D 64 and D 32 (lengths 3001-4096) and B 3 × S 512
      × D 32 with a zero-length row; f32 and bf16; window 0, 256, 256 +
      global CLS; q, k, v as views of a fused QKV; every row (f32 |Δ| ≤
      1e-4 · max(1, |ref|); bf16 |Δ| ≤ 2 · 2^-7 · max(1, |ref|), mean ≤
      6e-7; zero-length rows exactly 0). Timed at the training shape (B 4, S 4096, H 12, D 64,
      bf16; window 256 + global CLS, and window 0) beside the plain version
      and SDPA's backward (forward + backward − forward, boolean mask);
    - roberta-base-long (phase 6's conversion; f32 master weights, bf16
      compute, dropout 0.1) trains on 16 pairs (a 3000-4000-token document,
      the same sentences in another order) in batches of 4 at bucket 4096:
      MNRL, ``make_optimizer(TrainConfig(lr=2e-5, warmup_ratio=0.1))``,
      ``Trainer.execute`` with prefetch, two epochs (8 steps). Gates: K5
      launches = 12 layers × 2 towers × 8 steps, K6 = 2 × that; losses
      finite; the parameters unchanged by step 1 (lr 0) and changed by step
      2. Printed: pairs/s, tokens/s, peak memory, a ``torch.profiler``
      split of one step (K5, K6, GEMMs, the rest) and the optimizer step
      alone;
    - gradient agreement: a 2-layer cut of the same arch at full width, one
      pair at 4096, the gradient of a fixed random projection of both
      towers' token states through ``attention_impl="auto"`` (K5/K6) against
      ``"reference"``: per leaf ‖Δg‖ / ‖g‖ ≤ 1e-3 (f32) and ≤ ``GRAD_BF16``
      (bf16); another pair's gradient ≥ 10 × ``GRAD_BF16`` away;
    - the short path: minilm-l6 with the CLI's defaults (32 pairs, max_len
      128, the reference attention), cosine MSE on 64 synthetic pairs, 30
      steps on one repeated batch at lr 1e-4 through the Trainer with
      checkpoints: the loss falls; ``save`` → ``load`` gives the same
      embeddings; K2 finds each saved document's own vector first.
 8. head-packed attention:
    - K7 against its plain version on every row (padded query rows too),
      B 64 × S 128 × H 12, D 32 and 64, ragged lengths with a zero-length
      row, f32 and bf16, q, k, v as views of a fused QKV (f32 max |Δ| ≤
      1e-4; bf16 max ≤ 1e-2, mean ≤ 5e-4; zero-length rows exactly 0);
      timed at B 128 × S 128 × H 12 × D 32 bf16 (which must take the
      one-sweep kernel, as the kernel library reports its choice) beside
      the plain version and SDPA with a boolean key mask, the kernel and
      SDPA as the host calls them (the median of three rounds of 100
      calls) and on the device (100 calls in a CUDA graph);
    - minilm-l6 (phase 4's weights) runs ``encoder_forward`` with
      ``attention_impl="packed"`` over 2,048 texts in length-bucketed
      batches of 128 at 32 / 64 / 128, K7's counters zeroed just before (it
      must read 6 × the batches, all of them on the one-sweep kernel, which
      bf16 takes at S ≤ 128; the library's choice for each width printed);
      last_hidden_state on valid rows against
      the reference path within ``PACKED_AGREE_MEAN`` / ``PACKED_AGREE_MAX``,
      pooled cosine ≥ 0.99, another row ≥ 10 × the mean limit away; a
      ``torch.profiler`` split of one pass, with K7's share of its device
      time and its kernels' names.
 9. serving (phase 4's tokenizer, minilm-l6 encoder and 120,000- and
    2,000-document pipelines):
    - the 120,000 documents through the native and the Python tokenizer
      (``tokenize_many`` and the padded ``encode_batch``: equal ids) and
      ``pack_sequences`` with the native and the Python FFD (equal
      layouts), each host time printed;
    - a cross-encoder, minilm-l6 at full width with token types and the
      pooler (random weights from a seed, one output, its head scaled to
      std 1), must lie on the card; queueing a packed layout
      (``_dispatch_packed_layout``) must not synchronise (sync debug mode
      "error");
    - ``SearchServer`` (batch window 2 ms) over the 120,000-document
      pipeline with ``RankingPipeline(retrieve_k=100)``, and one over the
      2,000-document pipeline, on 127.0.0.1 port 0, queried with
      ``urllib``: ``/search`` of 1, 5 and 64 texts under phase 4's
      self-retrieval gate (K1's counter, zeroed just before, must rise with
      every launch on the wgmma tile; K2's on the 2,000-document server); 32
      concurrent one-text clients a server (on the brute server each answer
      equals the unbatched one: ids where separated, scores within
      ``BATCH_SCORE_TOL``; on the IVF server 10 finite scores best first);
      an empty ``/search`` answered 400, then a normal one; ``/rerank`` of
      1 query (100 pairs, which must take the packed auto route) and of 32
      (3,200 pairs, the wave path): each row the query's retrieved
      candidates, best first, its scores within ``RERANK_AGREE_MAX`` of the
      cross-encoder's bucketed ``predict`` (the spread across pairs printed
      beside it), K1 on the tile; ``/encode``, ``/add`` (a new document
      finds itself) and ``/remove`` (none comes back) of 100 documents,
      ``/health``, ``/metrics`` (no error but the empty request's);
    - ``python -m text_similarity_tpu_torch serve --model --load
      --rerank-model --int8 --port 0`` on the phase's saved encoder,
      pipeline and cross-encoder: "warmed rerank path" and "serving on …"
      within 120 s, ``/health``, one ``/search``, one ``/rerank``, SIGINT:
      exit 0 and no traceback or error line on its stderr.
    Printed, with the card: the tokenize and FFD host times, each server's
    ``/metrics`` p50 / p95, the 32-client rates, each ``/rerank``'s latency.
 10. training entry points (phase 4's tokenizer, corpus, minilm-l6
    weights and 2,000-document pipeline; data files written from the corpus
    into a temporary directory; the CLI's ``main([...])`` in this process
    with ``--device cuda``):
    - ALBERT albert-base (H 768, E 128, one shared layer run 12 times,
      random weights from seed 0): 2,000 sentences encoded with
      ``packed="auto"`` (which must pack) and ``packed=False`` under phase
      4's ``PACK_AGREE_*`` limits, each rate beside minilm-l6's; K7 through
      ``attention_impl="packed"`` over length-bucketed batches (its counter
      must read 12 × the batches; pooled cosine to the reference path ≥
      0.99); one bi-encoder loss in f32 with dropout 0: the shared leaves'
      gradient equals the sum of an unshared 12-layer copy's, per leaf
      within ``ALBERT_GRAD_REL``;
    - the packed step at bench.py's recipe (minilm-l6, 8,192 pairs of its
      length law as token rows, 64 rows × 128 a side, cosine MSE,
      ``remat=True``): pairs/s, a record; its gradient against the bucketed
      step's on the same 64 pairs (dropout 0) within ``GRAD_F32`` (f32) and
      ``GRAD_BF16`` (bf16) per leaf;
    - ``train-sts --packed --packed-rows 64 --max-len 128`` on 8,192 pairs
      of bench.py's length law made of corpus words: the loss finite, the
      saved model loads and encodes, the epoch's pairs/s;
    - ``train-cross-encoder --format paws``, packed and bucketed (256 pairs,
      8 steps): ``CrossEncoder.load`` of each saved directory feeds
      ``RankingPipeline`` over the 2,000-document pipeline; its packed and
      bucketed ``predict`` of the 100 candidates within ``RERANK_AGREE_MAX``;
    - ``train-ner`` (256 sentences), then ``train-classification`` and
      ``eval-classification`` (512 documents, 4 labels): finite losses, the
      accuracy printed;
    - ``pretrain-long --arch roberta-base --target-len 4096 --window 256
      --batch-size 2`` over 16 documents of 3,000-4,200 tokens (the first
      fills the 4,096-token row, where the reference reads past its
      position table): 8 steps at width 4096, every loss finite, K5 12 and
      K6 24 launches a step (watched through ``train.make_mlm_train_step``),
      the parameters moved; tokens/s, peak memory and a ``torch.profiler``
      split of one step.
 11. the main path's commands (phase 3's 1M rows and 4,096 queries; phase
    4's tokenizer, minilm-l6 encoder, 120,000-document corpus and pipeline;
    phase 9's cross-encoder; K1's and K2's counters zeroed just before and
    required to rise):
    - IVF mining: ``SentenceMiningPipeline._mine_ivf`` over the 1M rows at
      k 10 (every K1 launch on the wgmma tile); recall@10 of 4,096 sampled
      rows' neighbours against K2's exact top-11 less the row ≥ 0.95; K1 on
      256 of the mined rows (the first chunk's plan, k 11) against its plain
      version (phase 3's gate); rows/s printed. Exact mining:
      ``BruteForceIndex.mine`` over 20,000 f32 rows against the same mine
      through the plain ``cosine_topk`` (ids equal where separated, |Δ| ≤
      1e-5);
    - the CLI in this process with ``--device cuda`` over a file of the
      120,000 documents plus 1,000 verbatim copies of corpus lines:
      ``encode`` by the auto rule and with ``--packed`` (rows/s; the two
      ``.npy`` within phase 4's ``PACK_AGREE_*`` limits), ``search --query``
      on a corpus line (the IVF route; the line first, score ≥ 0.99),
      ``mine --ivf on`` and ``--ivf off`` (``--min-score 0.99 --top-k 3``:
      every planted pair by the exact route; by the IVF route ≥ 95% of the
      pairs whose copy lies in a slab that the original's query block probes,
      at least 400 pairs probed, none found outside them, and ≥ 45% of all
      1,000 found: the reference's block-union scan reaches no further,
      ROADMAP queue 3),
      ``quantize`` then ``compare-models`` over 2,000 documents and 100
      queries (the model against itself overlap 1.0; the int8 student's
      overlap a record);
    - the churn drive (``text_similarity_tpu_torch.drives.churn``) on the 1M
      rows and 4,096 queries with 100,000 new rows: post-churn recall@10 ≥
      0.95, no removed id in an answer, every re-added row found by its own
      query; remove and add rows/s printed;
    - the serve-load drive (``drives.serve_load``) against the 120,000-
      document pipeline and the cross-encoder (retrieve_k 100), phases A-D
      of 3 s: every request answered; queries/s and p50 / p95 printed;
    - phase 4's weights under HuggingFace's key names back through
      ``convert_state_dict``: 256 embeddings bit-equal to phase 4's;
      ``embed_token_stack`` equal to ``embed_tokens`` batch by batch;
    - ``AdaptiveParamOptimizer``: 4 trials over lr of 5 minilm-l6 steps,
      every loss finite.
 12. compression, clustering, topics and word models (phase 4's tokenizer,
    corpus and minilm-l6 encoder, full width; K2's counter zeroed just
    before and required to rise):
    - distill: a 3-layer student on 8,192 sentences (one epoch, batch 64),
      saved, loaded, 2,000 documents encoded and each found first by K2 at
      score ≥ 0.99; ``DimReducingDistiller`` to 128 dimensions; FastFormers
      on a minilm-l6 classifier; each loss's mean over its last 10 steps
      below its first step's; sentences/s printed;
    - theseus: ``theseus --slots 3`` on 4,096 PAWS-format pairs through the
      CLI, the student searched as above; the mixed forward at rate 1 equal
      to the 3-layer student's ``encoder_forward`` and at rate 0 to the
      teacher's (``THESEUS_BF16``);
    - prune: head and FFN importance over 8 batches on the card against
      the CPU (f32, max |Δ| / max |ref| ≤ ``IMPORTANCE_REL``); 12 → 8 heads
      at full FFN, whose logits on 256 rows equal the unpruned model's with
      the matching 0/1 head mask (f32, ``PRUNE_F32``); ``prune`` →
      ``eval-classification`` through the CLI;
    - export: b 32 × s 128 int8 on the card, reloaded, equal to the eager
      int8 encoder (max |Δ| ≤ 1e-5); ms a call beside the eager one; then
      b 2 × s 4096 int8 of phase 6's roberta-base at 4,098 positions,
      whose program carries K5's registered op: reloaded, equal to the
      eager int8 encoder (max |Δ| ≤ 1e-5), K5 12 launches a call, ms a
      call beside the eager one;
    - ``cluster`` (20,000 sentences, 50 clusters) and ``topics`` (5,000
      documents; kmeans + pca, hdbscan + spectral, whose k-NN graph is K2)
      through the CLI; ``train-wic`` on 512 synthetic rows (finite loss,
      the WiC accuracy printed).
 13. MoE and Performer (phase 4's corpus and tokenizer):
    - minilm-l6 at full width with 8 experts, top-2, capacity factor 1.25
      (the router-skew drive's arch), random weights, bf16: the 120,000-
      and 2,000-document pipelines (IVF, K1; brute force, K2) with
      ``moe_drop`` printed for the corpus encodes and the requests, phase
      4's self-retrieval gate (IVF requests among the queries whose own slab
      was probed: a query encoded alone routes otherwise than its document
      did in the corpus's batches), with floors on the single queries whose
      own slab was probed (``MOE_SINGLE_PROBED_MIN``) and on their IVF
      answers' recall@10 against an exact top-10 on the same query vectors
      (``MOE_SINGLE_RECALL_MIN``), the route gap (64 documents encoded
      alone against their corpus vectors) and the corpus encode repeated
      bit for bit; K2 (k 10, 20) and K1 (1-, 5-, 64-text requests) held to
      their plain versions at these shapes, outside their counted windows;
      ``to_int8`` (router f32, experts int8, min cosine to bf16 printed);
      one forward under ``torch.profiler`` split by MoE stage
      (``ts.moe.router``, ``ts.moe.dispatch``, ``ts.moe.experts``,
      ``ts.moe.combine`` spans) with the idle share; ``train-sts --experts 8`` on 512 pairs
      through the CLI (finite loss, ``moe_aux``, ``moe_drop``); 30
      bi-encoder steps whose loss falls; the router-skew drive's ``--train``
      (100 steps) and ``--sweep`` (b 1,024 × s 128), every row printed;
    - roberta-base at 4,098 positions (phase 6's weights) with Performer
      attention (m = head_dim), bf16: phase 6's 128 documents encoded with
      ``packed=False`` beside the same weights on the exact path (K5,
      window 0, 12 launches a 4096-token batch; the Performer path runs
      neither K5 nor K7), documents/s of both, the unit embeddings' gap
      printed and last_hidden_state of 8 documents gated
      (``PERFORMER_MEAN`` / ``PERFORMER_MAX``, the next document's rows as
      the control); K2 self-retrieval (held to its plain version); the card
      against the CPU on a 2-layer cut at 2 × 4096, f32
      (``PERFORMER_CARD_CPU``); causal FAVOR+ at 8 × 4096 × 12 × 64 against
      exact causal attention (max |Δ| printed, both timed), with 4 local
      heads equal to the banded causal attention; 8 bi-encoder steps with a
      redraw every 4 (two matrices drawn, new at step 4 only); ``encode``
      under ``packed="auto"`` of mixed lengths does not pack.
 14. The distributed serving path, every shard or position on the one
    card (``make_mesh(..., devices=["cuda:0"] * 4)``; no rate is a
    multi-card number):
    - phase 3's 1M × 384 rows over a 4-shard ``ShardedIVFIndex`` (C 2048
      global clusters by the distributed k-means, 56 probes, 8 iterations,
      bf16 slabs): recall@10 against phase 3's exact top-10 ≥ 0.95 beside
      the unsharded index's, QPS of both, K1 four launches a 4096-query
      call; each shard's K1 at its shapes against its plain version (phase
      3's gate; the route the kernel library took) and the sharded merge
      bit-equal to a host merge of the four answers;
    - phase 4's 120,000 minilm-l6 vectors over a 4-shard
      ``ShardedBruteForceIndex``: K2 four launches a call, each shard's K2
      against its plain version, the ids equal to ``BruteForceIndex``'s
      where the f32 scores are separated;
    - the daemon: ``SearchServer`` over a brute-force
      ``ShardedSearchPipeline`` of 20,000 documents (minilm-l6 bf16, the
      encode data-parallel over 4 positions: its min cosine to the
      mesh-less encode ≥ ``DP_MIN_COS``) on port 0: ``/health`` with
      ``sharded: true``, 32 one-text and one 64-text ``/search`` finding
      themselves (≥ 95%), ``/remove`` of 5 never answered after; then a
      query's 300 nearest documents removed: its k = 10 answer (512 a
      shard over the tombstones, K2's large-k route counted: the kernels
      line's launches) holds 10 live rows, none removed, the host's top 10
      of the live documents where separated; an IVF
      ``ShardedSearchPipeline`` over the same documents (32 one-text
      requests, tombstones); save → load the same answers; K1's and K2's
      counters zeroed just before these pipelines are built and read after
      (the kernels line's ``launches_sharded``); then, at a one-text and
      a 64-text request, each IVF shard's K1 at ``kernel_plan``'s blocks
      against its plain version (its route printed) with the merge
      bit-equal to a host merge, and each brute-force shard's K2 at k 10
      and the over-fetched k 16; ``serve --shards 2`` through
      ``build_server`` refused on this one card, naming the count;
    - roberta-base at 4,098 positions, window 0, bf16: 8 documents of up
      to 4096 tokens through ``encoder_forward_cp`` with seq 4, ring and
      Ulysses, against the single-device exact path (K5, 12 launches) on
      valid rows within phase 6's ``AGREE_MEAN`` / ``AGREE_MAX``, the next
      document's rows 10 × the mean limit away; ``encode_long`` of both
      strategies against ``encode`` (min cosine ≥ ``LONG_MIN_COS``, the
      next document's vector below it), both timed (docs/s); the card
      against the CPU on a 2-layer cut at 1 × 4096, f32 (``CP_CARD_CPU``).
 15. Distributed training, every position on the one card
    (``devices=["cuda:0"] * 4``; no rate is a multi-card number). Gradients
    are held per leaf as phase 7 holds them (‖Δg‖/‖g‖ ≤ ``GRAD_F32`` in f32;
    in bf16 ≤ ``GRAD_BF16`` or, where larger, twice the leaf's distance
    between the mesh-less bf16 and f32 runs; another batch ≥ 10 ×
    ``GRAD_BF16`` away), dropout 0 where results are compared:
    - data 4 and FSDP 4 (``fsdp_param_pspecs``): minilm-l6, MNRL on 64 pairs
      × 128 tokens, bf16 and f32, against the mesh-less step: the loss, the
      gradients, the parameters after 4 steps (‖p − p_ref‖/‖p_ref − p0‖,
      ``GRAD_BF16``, the leaves whose gradient is rounding noise named and
      not gated), pairs/s of both; FSDP: every split leaf's piece ¼, each
      position's bytes of parameters and moments beside the replicated
      bytes;
    - data 2 × model 2 (``param_pspecs``): roberta-base at 4,098 positions
      (phase 6's weights), 4 pairs at 4096, window 256 + CLS: the gradients
      of phase 7's projection loss in bf16 and f32 against the mesh-less
      path, one MNRL step with K5 96 and K6 192 launches (each model
      position's 6 heads), pairs/s beside the mesh-less step's; K5 and K6
      held to their plain versions at (2, 4096, 6, 64) and at the pipe's
      (1, 4096, 12, 64);
    - pipe 4 × 4 microbatches (3 layers a stage): ``encoder_forward_pp``'s
      last_hidden_state against ``encoder_forward`` on valid rows (phase 6's
      ``AGREE_MEAN`` / ``AGREE_MAX``), the gradients as above, one MNRL step
      with K5 96 and K6 192 launches; with dropout 0.1 the loss finite and
      two identical microbatches different;
    - data 2 × expert 2: minilm-l6 with 8 experts, top-2, f32: the forward's
      states, ``moe_aux`` and ``moe_drop`` against the replicated forward,
      the MNRL gradients;
    - ``dryrun_multichip(4)``; the data-parallel encoder unsharded, saved,
      loaded and searched (K2, every document first); ``train-sts --pipe
      2`` refused, naming the card count.
 16. One JSON line ``{"kernels": [...]}`` for K1-K8, K1-opt (per_probe,
    emit_acc), K9, K10, K11a and K11b: launches in the counted window of
    their phase (2b, 4, 5, 5b, 6, 7 or 8), time, plain time, bound and
    library time at the phase-2/2b/3/5/5b/6/7/8 shapes; K5 and K6 carry
    window 256 + CLS in ``ms`` / ``library_ms`` / ``bound_ms`` and window 0
    in ``ms_window0`` / ``library_ms_window0`` / ``bound_ms_window0``; K2
    and K3 carry Q 1, 8, 64 and 256 in ``ms_by_q`` / ``bound_ms_by_q`` /
    ``library_ms_by_q``; K7 its timed ``path`` and, beside its times as
    the host calls it, its device times in a CUDA graph (``device_ms`` /
    ``library_device_ms``); K8's pass B has two rows (over the kept scores,
    and on the score tile); K1 and K2 also carry ``launches_sharded``, their
    launches in phase 14's counted window; K5 and K6 ``launches_distributed``,
    theirs in phase 15's two counted steps. The large-k route has four
    rows: K2's (``cosine_topk_large``: ms at k 1000, ``ms_by_k`` at 300,
    1000 and 4096 beside ``library_ms_by_k``, launches in phase 14's
    removal window), K3's (``cosine_topk_int8_large``, launches in phase
    5's brute-force window), K8's pass A (``topk_2pass_fold_large``, k 300,
    launches in its phase-2b window) and K1 / K4's exact scan
    (``ivf_scan_large_k``, k 300; launches, the emit_acc and select launches
    together and apart as ``launches_emit`` / ``launches_select``, in phase
    3's and, with ``_int8``, phase 5's ``IVFIndex.query``; its bound is the
    scan's own bytes and operations, ``candidates_ms`` the design's (U, B,
    Mc) candidate round trip beside it).
 17. The card again, then ``{"ok": true, "device": {...}}`` as the last line.

Every time is measured here, on this card, with CUDA events (kernels) or
the host clock around synchronised work (pipeline). f32 matmuls run
without TF32 (``allow_tf32 = False``): the plain versions are exact f32.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel
PEAK_BYTES = 3.35e12        # HBM3 bytes/s
PEAK_F32 = 67e12            # f32 FLOP/s outside the tensor cores
PEAK_BF16 = 989e12          # bf16 tensor-core FLOP/s


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 100, replays: int = 3) -> float:
    """The device's time for one call of ``fn``: ``iters`` calls captured in
    one CUDA graph (after three warm-up calls on a side stream), replayed
    once to warm, then ``replays`` times between two CUDA events; the time
    over ``replays`` × ``iters``. The host's cost of a call (the wrapper's
    checks, allocations and the launch itself), which ``time_ms`` also
    measures where it exceeds the kernel's, is left out: a graph launches
    its kernels back to back."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def bound_ms(n_bytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def overlap(a, b) -> float:
    return float(np.mean([len(set(r) & set(s)) / len(r) for r, s in zip(a, b)]))


def separated_ids_equal(ki, ri, rs, tol=1e-5, next_scores=None) -> bool:
    """ids equal at every rank whose reference score differs from both
    neighbours by more than tol (near-ties may swap under another
    summation order); ``next_scores`` (the reference's (k + 1)-th score a
    row) is the last rank's lower neighbour, else nothing lies below it."""
    below = -np.inf if next_scores is None else np.asarray(next_scores)[:, None]
    gap = np.minimum(
        np.abs(np.diff(rs, axis=1, prepend=np.inf)),
        np.abs(np.diff(rs, axis=1, append=below)),
    )
    sep = gap > tol
    return bool(np.array_equal(ki[sep], ri[sep]))


# ---------------------------------------------------------------------------
# Phase 2: K2
# ---------------------------------------------------------------------------

def topk_inputs(torch, seed=2, n=100_003, d=384):
    """Phase 2's corpus (unit rows, 256 of them with two exact copies in
    the second half) and 256 queries near the copied rows."""
    from text_similarity_tpu_torch.ops.topk import l2_normalize

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    corpus = l2_normalize(torch.randn(n, d, generator=g, device=dev))
    src = torch.randperm(n // 2, generator=g, device=dev)[:256]
    dst = n // 2 + torch.randperm(n - n // 2, generator=g, device=dev)[:512]
    corpus[dst[:256]] = corpus[src]
    corpus[dst[256:]] = corpus[src]       # three copies: exact ties
    queries = l2_normalize(corpus[src] + 0.05 * torch.randn(256, d, generator=g, device=dev))
    return corpus, queries


def agree_topk(ks, ki, rs, ri, exact, next_scores=None):
    """(max |Δscore|, ok, detail): f32 ids equal where scores are separated
    and |Δ| ≤ 1e-5; bf16 overlap ≥ 0.99 and |Δ| ≤ 1e-4."""
    ks, ki, rs, ri = (t.cpu().numpy() for t in (ks, ki, rs, ri))
    err = float(np.abs(ks - rs).max())
    if exact:
        return err, err <= 1e-5 and separated_ids_equal(ki, ri, rs, next_scores=next_scores), \
            f"ids equal {np.mean(ki == ri):.4f}"
    ov = overlap(ki, ri)
    return err, err <= 1e-4 and ov >= 0.99, f"overlap {ov:.4f}"


def phase_topk(torch, card):
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda, cosine_topk_reference

    corpus, queries = topk_inputs(torch)
    n, d = corpus.shape
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        c = corpus.to(dtype).contiguous()
        for q_n in (1, 7, 256):
            q = queries[:q_n].contiguous()
            for k in (10, 20):
                ks, ki = cosine_topk_cuda(q, c, k)
                rs, ri = cosine_topk_reference(q, c, k)
                err, ok, detail = agree_topk(ks, ki, rs, ri, dtype == torch.float32)
                worst = max(worst, err)
                log(f"K2 {str(dtype)[6:]} Q={q_n} k={k}: max|Δscore| {err:.2e}, {detail}"
                    f" -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("K2 disagrees with its plain version")
    # timing at the main shape: f32 corpus (the pipeline's store), Q=256, k=10
    q, k = queries.contiguous(), 10
    ms = time_ms(torch, lambda: cosine_topk_cuda(q, corpus, k))
    plain = time_ms(torch, lambda: cosine_topk_reference(q, corpus, k), iters=3, warmup=1)
    lib = time_ms(torch, lambda: torch.topk(q @ corpus.T, k, dim=1))
    qn = q.shape[0]
    b_ms, b_by = bound_ms(qn * d * 4 + n * d * 4 + qn * k * 8, 2.0 * qn * n * d, PEAK_F32)
    corpus_bf16 = corpus.to(torch.bfloat16)
    ms_bf16 = time_ms(torch, lambda: cosine_topk_cuda(q, corpus_bf16, k))
    # the pipeline's padded request sizes (BruteForceIndex pads Q to a power
    # of two) beside the table's Q 256, each with its bound and the library
    by_q, bound_by_q, lib_by_q = {}, {}, {}
    for q_n in (1, 8, 64, 256):
        qq = q[:q_n].contiguous()
        by_q[q_n] = ms if q_n == qn else time_ms(torch, lambda: cosine_topk_cuda(qq, corpus, k))
        lib_by_q[q_n] = lib if q_n == qn else time_ms(
            torch, lambda: torch.topk(qq @ corpus.T, k, dim=1))
        bound_by_q[q_n] = bound_ms(q_n * d * 4 + n * d * 4 + q_n * k * 8, 2.0 * q_n * n * d,
                                   PEAK_F32)
    log(f"K2 times [{card}]: f32 Q=256 k=10 kernel {ms:.3f} ms, plain {plain:.3f} ms, "
        f"torch.topk(q@cT) {lib:.3f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"bf16 corpus {ms_bf16:.3f} ms")
    for q_n in (1, 8, 64, 256):
        log(f"K2 f32 Q={q_n} k=10 [{card}]: kernel {by_q[q_n]:.4f} ms, torch.topk(q@cT) "
            f"{lib_by_q[q_n]:.4f} ms, bound {bound_by_q[q_n][0]:.4f} ms ({bound_by_q[q_n][1]})")
    return {
        "name": "cosine_topk", "route": "cuda",
        "source": "text_similarity_tpu_torch/csrc/topk.cu",
        "replaces": "text_similarity_tpu/ops/topk.py:307",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "shape": f"Q=256 N={n} D={d} k=10 f32",
        "ms_by_q": by_q, "bound_ms_by_q": {q_n: b for q_n, (b, _) in bound_by_q.items()},
        "library_ms_by_q": lib_by_q, "ms_bf16": ms_bf16,
    }


LARGE_KS = (300, 1000, 4096)


LARGE_QS = (1, 8, 64, 256)


def phase_large_k(torch, card):
    """The large-k route (``csrc/topk_select.cu``) of K2 (f32, bf16) and K3
    (int8) at k ∈ ``LARGE_KS`` on phase 2's corpus (N 100,003 × D 384,
    exact ties), at Q ∈ ``LARGE_QS`` (the first Q of its 256 queries),
    against the plain versions: f32 and int8 ids equal where the scores are
    separated, scores allclose 1e-5, and f32 at k 300 equal to the
    selector's answer at k 256 bit for bit on its first 256 (the same score
    bits, the same tie rule); bf16 id overlap ≥ 0.99. Each time at each Q
    beside ``torch.topk(q @ cᵀ, k)``'s and the bound (the f32 operations,
    or the corpus read and the (Q, N) score write and read), and the select
    kernel alone over the (Q, N) f32 scores beside its own bound (one read
    of them, the answer written). → the rows of the K2 and K3 routes
    (launches filled in by phases 14 and 5)."""
    from text_similarity_tpu_torch.compress.quantize import quantize_embeddings_int8
    from text_similarity_tpu_torch.ops import topk

    corpus, queries = topk_inputs(torch)
    n, d = corpus.shape
    q = queries.contiguous()
    qn = q.shape[0]
    codes, scales = quantize_embeddings_int8(corpus)
    kinds = {"f32": corpus, "bf16": corpus.to(torch.bfloat16).contiguous(), "int8": codes}
    by_q = {q_n: q[:q_n].contiguous() for q_n in LARGE_QS}

    def run(kind, k, plain=False, q_n=qn):
        qq = by_q[q_n]
        if kind == "int8":
            fn = topk.cosine_topk_int8_reference if plain else topk.cosine_topk_int8_cuda
            return fn(qq, codes, scales, k)
        fn = topk.cosine_topk_reference if plain else topk.cosine_topk_cuda
        return fn(qq, kinds[kind], k)

    before = (topk.cosine_topk_cuda.launches, topk.cosine_topk_int8_cuda.launches)
    worst = {"f32": 0.0, "bf16": 0.0, "int8": 0.0}
    for kind in kinds:
        for q_n in LARGE_QS:
            for k in LARGE_KS:
                ks, ki = run(kind, k, q_n=q_n)
                rs, ri = run(kind, k + 1, plain=True, q_n=q_n)
                torch.cuda.synchronize()
                sorted_ok = bool((ks[:, 1:] <= ks[:, :-1]).all())
                err, ok, detail = agree_topk(ks, ki, rs[:, :k], ri[:, :k], kind != "bf16",
                                             next_scores=rs[:, k].cpu().numpy())
                ov = overlap(ki.cpu().numpy(), ri[:, :k].cpu().numpy())
                ok = ok and sorted_ok and ov >= 0.99
                worst[kind] = max(worst[kind], err)
                log(f"large-k route {kind} Q={q_n} k={k}: max|Δscore| {err:.2e}, {detail}, "
                    f"id-set overlap {ov:.4f}, sorted {sorted_ok} -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"the large-k route ({kind}, Q {q_n}, k {k}) disagrees "
                                         "with its plain version")
    ls, li = topk.cosine_topk_cuda(q, corpus, 300)
    ss, si = topk.cosine_topk_cuda(q, corpus, 256)
    same = bool(torch.equal(ls[:, :256], ss) and torch.equal(li[:, :256], si))
    log(f"large-k route at k 300 against the selector at k 256 (f32): first 256 bit-equal {same}")
    after = (topk.cosine_topk_cuda.launches, topk.cosine_topk_int8_cuda.launches)
    if not same or after != (before[0] + 1, before[1]):
        raise AssertionError(f"the large-k route's first 256 differ from the selector's, or a "
                             f"selector kernel ran above 256 (launches {before} -> {after})")

    # where the time goes: the select kernel alone over each Q's f32 scores,
    # beside torch.topk over them
    select_by_q, select_lib_by_q = {}, {}
    for q_n in LARGE_QS:
        scores = by_q[q_n] @ corpus.T
        select_by_q[q_n] = {k: time_ms(torch, lambda: topk.topk_select_cuda(scores, k))
                            for k in LARGE_KS}
        select_lib_by_q[q_n] = {k: time_ms(torch, lambda: torch.topk(scores, k, dim=1))
                                for k in LARGE_KS}
        bounds = {k: bound_ms(q_n * n * 4 + q_n * k * 8, 0.0, PEAK_F32)[0] for k in LARGE_KS}
        if q_n == qn:
            pos = torch.arange(n, dtype=torch.int32, device=scores.device).expand(qn, n)
            select_plain = time_ms(torch, lambda: topk.select_topk_plain(scores, pos, 1000),
                                   iters=3, warmup=1)
        del scores
        log(f"large-k select alone over the ({q_n}, {n}) f32 scores [{card}]: " + ", ".join(
            f"k {k} {select_by_q[q_n][k]:.4f} ms (torch.topk {select_lib_by_q[q_n][k]:.4f}, "
            f"bound {bounds[k]:.4f})" for k in LARGE_KS))
    log(f"large-k select's plain version at Q {qn}, k 1000 [{card}]: {select_plain:.3f} ms")
    rows = []
    for kind, name, replaces in (
        ("f32", "cosine_topk_large", "text_similarity_tpu/ops/topk.py:307"),
        ("int8", "cosine_topk_int8_large", "text_similarity_tpu/ops/topk.py:617"),
    ):
        by_qk, lib_by_qk, bound_by_qk, bf16_by_qk = {}, {}, {}, {}
        c_bytes = n * d + n * 4 if kind == "int8" else n * d * 4
        for q_n in LARGE_QS:
            qq = by_q[q_n]
            by_qk[q_n], lib_by_qk[q_n], bound_by_qk[q_n] = {}, {}, {}
            if kind == "f32":
                bf16_by_qk[q_n] = {}
            for k in LARGE_KS:
                by_qk[q_n][k] = time_ms(torch, lambda: run(kind, k, q_n=q_n))
                if kind == "int8":
                    lib_by_qk[q_n][k] = time_ms(torch, lambda: torch.topk(
                        (qq @ codes.float().T) * scales, k, dim=1))
                else:
                    lib_by_qk[q_n][k] = time_ms(torch, lambda: torch.topk(qq @ corpus.T, k,
                                                                          dim=1))
                    bf16_by_qk[q_n][k] = time_ms(torch, lambda: run("bf16", k, q_n=q_n))
                # inputs once, the (Q, N) scores written and read once, the answer
                bound_by_qk[q_n][k] = bound_ms(
                    q_n * d * 4 + c_bytes + 2 * q_n * n * 4 + q_n * k * 8, 2.0 * q_n * n * d,
                    PEAK_F32)
                bf16 = f", bf16 corpus {bf16_by_qk[q_n][k]:.3f} ms" if kind == "f32" else ""
                b, by = bound_by_qk[q_n][k]
                log(f"large-k route {kind} Q={q_n} N={n} k={k} [{card}]: kernels "
                    f"{by_qk[q_n][k]:.3f} ms{bf16}, torch.topk {lib_by_qk[q_n][k]:.3f} ms, "
                    f"bound {b:.4f} ms ({by})")
        plain = time_ms(torch, lambda: run(kind, 1000, plain=True), iters=3, warmup=1)
        b_ms, b_by = bound_by_qk[qn][1000]
        row = {
            "name": name, "route": "cuda", "source": "text_similarity_tpu_torch/csrc/topk_select.cu",
            "replaces": replaces, "max_abs_err": worst[kind], "ms": by_qk[qn][1000],
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_by_qk[qn][1000], "shape": f"Q={qn} N={n} D={d} k=1000 {kind}",
            "ms_by_k": by_qk[qn], "bound_ms_by_k": {k: b for k, (b, _) in bound_by_qk[qn].items()},
            "library_ms_by_k": lib_by_qk[qn], "ms_by_q_k": by_qk, "library_ms_by_q_k": lib_by_qk,
            "bound_ms_by_q_k": {q_n: {k: b for k, (b, _) in v.items()}
                                for q_n, v in bound_by_qk.items()},
        }
        if kind == "f32":
            row["ms_bf16_by_k"] = bf16_by_qk[qn]
            row["ms_bf16_by_q_k"] = bf16_by_qk
            row["max_abs_err_bf16"] = worst["bf16"]
            row["select_ms_by_k"] = select_by_q[qn]
            row["select_ms_by_q_k"] = select_by_q
            row["select_library_ms_by_q_k"] = select_lib_by_q
            row["select_plain_ms"] = select_plain
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Phase 2b: K8 (the certified two-pass top-k)
# ---------------------------------------------------------------------------

def collision_inputs(torch, n=100_003, d=384, q_n=8):
    """The reference's collision recipe at phase 2's size: two near-copies
    of the query's target 2048 rows apart share a lane class, so pass A
    hides one of them and the call must fall back to K2."""
    from text_similarity_tpu_torch.ops.topk import l2_normalize

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    corpus = 0.01 * torch.randn(n, d, generator=g, device=dev)
    target = torch.randn(d, generator=g, device=dev)
    corpus[5] = target + 0.001 * torch.randn(d, generator=g, device=dev)
    corpus[5 + 2048] = target + 0.001 * torch.randn(d, generator=g, device=dev)
    return l2_normalize(corpus), l2_normalize(target[None].repeat(q_n, 1))


def k8_counts(topk):
    kept = topk.topk_2pass_count_cuda.launches_scores
    return {"fold": topk.topk_2pass_fold_cuda.launches,
            "count": topk.topk_2pass_count_cuda.launches - kept,
            "count (scores)": kept,
            "fallbacks": topk.cosine_topk_2pass.fallbacks,
            "cosine_topk (fallback)": topk.cosine_topk_cuda.launches}


def phase_topk_2pass(torch, card):
    """K8 through its entry point ``cosine_topk_2pass`` at phase 2's shapes
    (Q ∈ {1, 7, 256}, k ∈ {10, 20}, f32 and bf16 corpora; pass B counts
    over pass A's kept scores) and at Q 1024, k 10 (scores over 256 MiB:
    pass B on the score tile), counted; then each call against the plain
    version and K2, each pass against its plain version (pass A's kept
    scores equal K2's bit for bit), the collision corpus (must fall back),
    and the times at Q 256, k 10 beside K2 and ``torch.topk(q @ cᵀ)``. →
    the three kernels' rows."""
    from text_similarity_tpu_torch.ops import topk

    corpus, queries = topk_inputs(torch)
    n, d = corpus.shape
    g = torch.Generator(device=corpus.device).manual_seed(5)
    queries = torch.cat([queries, topk.l2_normalize(
        corpus[:768] + 0.05 * torch.randn(768, d, generator=g, device=corpus.device))])
    corpora = {dt: corpus.to(dt).contiguous() for dt in (torch.float32, torch.bfloat16)}
    cases = [(dt, q_n, k) for dt in corpora for q_n in (1, 7, 256) for k in (10, 20)]
    cases += [(dt, 1024, 10) for dt in corpora]

    # the path: the entry point on every case, with the counters zeroed
    topk.topk_2pass_fold_cuda.launches = topk.topk_2pass_count_cuda.launches = 0
    topk.topk_2pass_count_cuda.launches_scores = 0
    topk.cosine_topk_cuda.launches = topk.cosine_topk_2pass.fallbacks = 0
    results = {}
    for dt, q_n, k in cases:
        before = topk.cosine_topk_2pass.fallbacks
        out = topk.cosine_topk_2pass(queries[:q_n].contiguous(), corpora[dt], k)
        results[(dt, q_n, k)] = (*out, topk.cosine_topk_2pass.fallbacks > before)
    torch.cuda.synchronize()
    launches = k8_counts(topk)
    log(f"launches during the K8 path ({len(cases)} calls of cosine_topk_2pass): {launches}")
    if (launches["fold"] != len(cases) or launches["count (scores)"] != len(cases) - 2
            or launches["count"] != 2):
        raise AssertionError(f"K8's passes launched {launches}, expected {len(cases)} folds, "
                             f"{len(cases) - 2} counts over kept scores and 2 on the tile")

    worst = {"fold": 0.0, "count": 0.0, "count (scores)": 0.0}
    for (dt, q_n, k), (ks, ki, fell) in results.items():
        q, c, exact = queries[:q_n].contiguous(), corpora[dt], dt == torch.float32
        before = topk.cosine_topk_2pass.fallbacks
        rs, ri = topk.cosine_topk_2pass_reference(q, c, k)
        plain_fell = topk.cosine_topk_2pass.fallbacks > before
        es, ei = topk.cosine_topk_cuda(q, c, k)
        fs, fi = topk.topk_2pass_fold_cuda(q, c, k)
        ps, pi = topk.topk_2pass_fold_plain(q, c, k, 2048)
        # pass B at thresholds halfway across the first gap wider than 1e-5
        # at or below the exact k-th score: no score lies near them (copied
        # rows tie exactly, and two summation orders may split such a tie)
        ts, _ = topk.cosine_topk_reference(q, c, k + 8)
        at = (ts[:, k - 1:-1] - ts[:, k:] > 1e-5).int().argmax(dim=1) + k - 1
        rows = torch.arange(q_n, device=q.device)
        thr = 0.5 * (ts[rows, at] + ts[rows, at + 1])
        cnt = topk.topk_2pass_count_cuda(q, c, thr)
        pcnt = topk.topk_2pass_count_plain(q, c, thr, 2048)
        s = topk._dot_dtype_queries(q, c) @ c.float().T
        near = ((s - thr[:, None]).abs() <= 1e-5).sum(dim=1)
        cnt_err = int((cnt - pcnt).abs().max())
        count_ok = bool(((cnt - pcnt).abs() <= near).all())
        # pass A's kept scores: K2's bit for bit at K2's ids, and pass B over
        # them counts what the tile's pass B counts
        _, _, kept = topk._fold_cuda(q, c, k, 2048, True)
        same_bits = bool(torch.equal(torch.gather(kept, 1, ei.long()), es))
        scnt = topk.topk_2pass_count_cuda(q, c, thr, scores=kept)
        scnt_err = int((scnt - pcnt).abs().max())
        count_ok = (count_ok and same_bits and torch.equal(scnt, cnt)
                    and torch.equal(scnt, topk.topk_2pass_count_scores_plain(kept, thr, n)))
        del kept, s
        err, ok, detail = agree_topk(ks, ki, rs, ri, exact)
        _, ok_k2, detail_k2 = agree_topk(ks, ki, es, ei, exact)
        ferr, ok_fold, detail_fold = agree_topk(fs, fi, ps, pi, exact)
        worst["fold"] = max(worst["fold"], err, ferr)
        worst["count"] = max(worst["count"], float(cnt_err))
        worst["count (scores)"] = max(worst["count (scores)"], float(scnt_err))
        ok = ok and ok_k2 and ok_fold and count_ok and fell == plain_fell
        log(f"K8 {str(dt)[6:]} Q={q_n} k={k}: fell back {fell} (plain {plain_fell}); against "
            f"the plain version max|Δscore| {err:.2e}, {detail}; against K2 {detail_k2}; pass A "
            f"alone max|Δ| {ferr:.2e}, {detail_fold}, its kept scores K2's bit for bit "
            f"{same_bits}; pass B alone max|Δcount| {cnt_err} (over the kept scores "
            f"{scnt_err}) at thresholds between scores -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K8 disagrees with its plain version or with K2, or falls "
                                 "back where the plain version does not")

    # the collision corpus: the certification must fail and K2 answer
    cc, cq = collision_inputs(torch)
    for dt in (torch.float32, torch.bfloat16):
        c = cc.to(dt).contiguous()
        before = k8_counts(topk)
        ks, ki = topk.cosine_topk_2pass(cq, c, 10)
        torch.cuda.synchronize()
        delta = {key: v - before[key] for key, v in k8_counts(topk).items()}
        before = topk.cosine_topk_2pass.fallbacks
        rs, ri = topk.cosine_topk_2pass_reference(cq, c, 10)
        plain_fell = topk.cosine_topk_2pass.fallbacks > before
        err, ok, detail = agree_topk(ks, ki, rs, ri, dt == torch.float32)
        both = all({5, 5 + 2048} <= set(row) for row in ki.cpu().tolist())
        ok = (ok and both and delta["fallbacks"] == 1 and delta["cosine_topk (fallback)"] == 1
              and plain_fell)
        log(f"K8 collision corpus {str(dt)[6:]} (Q=8, k=10): launches {delta}; the plain version "
            f"fell back {plain_fell}; both near-copies in every row {both}; against the plain "
            f"version max|Δscore| {err:.2e}, {detail} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K8 did not fall back to K2 on the collision corpus")

    # the large-k route: the call at k 300 (Q 256, f32), counted; pass A
    # selects its classes' winners with the select kernel
    q, c, k = queries[:256].contiguous(), corpora[torch.float32], 300
    topk.topk_2pass_fold_cuda.launches_large = 0
    before = topk.cosine_topk_2pass.fallbacks
    ks, ki = topk.cosine_topk_2pass(q, c, k)
    torch.cuda.synchronize()
    large = topk.topk_2pass_fold_cuda.launches_large
    fell = topk.cosine_topk_2pass.fallbacks > before
    before = topk.cosine_topk_2pass.fallbacks
    rs, ri = topk.cosine_topk_2pass_reference(q, c, k)
    plain_fell = topk.cosine_topk_2pass.fallbacks > before
    err300, ok, detail = agree_topk(ks, ki, rs, ri, True)
    fs, fi = topk.topk_2pass_fold_cuda(q, c, k)
    ps, pi = topk.topk_2pass_fold_plain(q, c, k, 2048)
    ferr300, fok, fdetail = agree_topk(fs, fi, ps, pi, True)
    ok = ok and fok and fell == plain_fell and large == 1
    log(f"K8 large-k route f32 Q=256 k={k}: pass A's select launches {large}; fell back {fell} "
        f"(plain {plain_fell}); against the plain version max|Δscore| {err300:.2e}, {detail}; "
        f"pass A alone max|Δ| {ferr300:.2e}, {fdetail} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K8 at k 300 disagrees with its plain version")
    ms_fold300 = time_ms(torch, lambda: topk.topk_2pass_fold_cuda(q, c, k))
    ms_call300 = time_ms(torch, lambda: topk.cosine_topk_2pass(q, c, k))
    plain_fold300 = time_ms(torch, lambda: topk.topk_2pass_fold_plain(q, c, k, 2048), iters=1,
                            warmup=1)
    lib300 = time_ms(torch, lambda: torch.topk(q @ c.T, k, dim=1))
    fold300_b, fold300_by = bound_ms(q.shape[0] * d * 4 + n * d * 4 + q.shape[0] * k * 8,
                                     2.0 * q.shape[0] * n * d, PEAK_F32)
    log(f"K8 large-k times [{card}]: f32 Q=256 k={k}: pass A {ms_fold300:.3f} ms (plain "
        f"{plain_fold300:.3f}), the call {ms_call300:.3f} ms with its fallback, torch.topk(q@cT) "
        f"{lib300:.3f} ms, bound {fold300_b:.4f} ms ({fold300_by})")

    # times at the main shape: f32 corpus, Q = 256, k = 10
    q, c, k = queries[:256].contiguous(), corpora[torch.float32], 10
    qn = q.shape[0]
    fs, _, kept = topk._fold_cuda(q, c, k, 2048, True)
    thr = fs[:, k - 1].clone()

    def passes():
        out_s, _, t, cnt = topk._passes_cuda(q, c, k, 2048)
        return bool((cnt == (out_s > t[:, None]).sum(dim=1, dtype=torch.int32)).all())

    certified = passes()
    ms_fold = time_ms(torch, lambda: topk._fold_cuda(q, c, k, 2048, True))
    ms_fold_alone = time_ms(torch, lambda: topk.topk_2pass_fold_cuda(q, c, k))
    ms_count = time_ms(torch, lambda: topk.topk_2pass_count_cuda(q, c, thr))
    ms_count_scores = time_ms(torch, lambda: topk.topk_2pass_count_cuda(q, c, thr, scores=kept))
    ms_passes = time_ms(torch, passes)
    ms_call = time_ms(torch, lambda: topk.cosine_topk_2pass(q, c, k))
    ms_k2 = time_ms(torch, lambda: topk.cosine_topk_cuda(q, c, k))
    plain_fold = time_ms(torch, lambda: topk.topk_2pass_fold_plain(q, c, k, 2048), iters=3, warmup=1)
    plain_count = time_ms(torch, lambda: topk.topk_2pass_count_plain(q, c, thr, 2048),
                          iters=3, warmup=1)
    plain_count_scores = time_ms(torch, lambda: topk.topk_2pass_count_scores_plain(kept, thr, n))
    lib = time_ms(torch, lambda: torch.topk(q @ c.T, k, dim=1))
    q7 = queries[:7].contiguous()
    ms_q7 = time_ms(torch, lambda: topk.cosine_topk_2pass(q7, c, k))
    ops = 2.0 * qn * n * d
    fold_b, fold_by = bound_ms(qn * d * 4 + n * d * 4 + qn * k * 8, ops, PEAK_F32)
    count_b, count_by = bound_ms(qn * d * 4 + n * d * 4 + qn * 8, ops, PEAK_F32)
    # pass B over the kept scores reads them once: 4·Q·N bytes
    stream_b, stream_by = bound_ms(qn * n * 4 + qn * 8, qn * n, PEAK_F32)
    log(f"K8 times [{card}]: f32 Q={qn} N={n} k={k}: pass A {ms_fold:.3f} ms keeping its "
        f"{qn * n * 4 / 1e6:.1f} MB of scores ({ms_fold_alone:.3f} without; plain "
        f"{plain_fold:.3f}), pass B over them {ms_count_scores:.4f} ms (plain "
        f"{plain_count_scores:.4f}; bound {stream_b:.4f} ms, {stream_by}), pass B on the score "
        f"tile {ms_count:.3f} ms (plain {plain_count:.3f}); both passes + the certification "
        f"{ms_passes:.3f} ms (certified: {certified}); cosine_topk_2pass {ms_call:.3f} ms with "
        f"its fallback; K2 {ms_k2:.3f} ms; torch.topk(q@cT) {lib:.3f} ms; bound "
        f"{fold_b:.4f} ms ({fold_by}) a pass on the tile; Q=7 call {ms_q7:.3f} ms")
    del kept
    row = {"route": "cuda", "source": "text_similarity_tpu_torch/csrc/topk_2pass.cu",
           "shape": f"Q={qn} N={n} D={d} k={k} f32"}
    return [
        {"name": "topk_2pass_fold", **row, "replaces": "text_similarity_tpu/ops/topk.py:445",
         "launches": launches["fold"], "max_abs_err": worst["fold"], "ms": ms_fold,
         "ms_without_scores": ms_fold_alone, "plain_ms": plain_fold, "bound_ms": fold_b,
         "bound_by": fold_by, "library_ms": lib, "ms_passes_certified": ms_passes,
         "ms_call": ms_call},
        {"name": "topk_2pass_count", **row, "replaces": "text_similarity_tpu/ops/topk.py:474",
         "launches": launches["count"], "max_abs_err": worst["count"], "ms": ms_count,
         "plain_ms": plain_count, "bound_ms": count_b, "bound_by": count_by, "library_ms": None},
        {"name": "topk_2pass_count_scores", **row,
         "replaces": "text_similarity_tpu/ops/topk.py:474",
         "launches": launches["count (scores)"], "max_abs_err": worst["count (scores)"],
         "ms": ms_count_scores, "plain_ms": plain_count_scores, "bound_ms": stream_b,
         "bound_by": stream_by, "library_ms": None},
        {"name": "topk_2pass_fold_large", "route": "cuda",
         "source": "text_similarity_tpu_torch/csrc/topk_select.cu",
         "replaces": "text_similarity_tpu/ops/topk.py:445", "shape": f"Q={qn} N={n} D={d} k=300 f32",
         "launches": large, "max_abs_err": max(err300, ferr300), "ms": ms_fold300,
         "plain_ms": plain_fold300, "bound_ms": fold300_b, "bound_by": fold300_by,
         "library_ms": lib300, "ms_call": ms_call300},
    ]


# ---------------------------------------------------------------------------
# Phase 3: K1
# ---------------------------------------------------------------------------

def bench_corpus(torch, n, n_q, d=384, seed=0):
    """bench.py's recipe on the card (the churn drive's): 4096 gaussian
    centres ×3 + unit noise; queries are corpus rows + 0.1 noise."""
    from text_similarity_tpu_torch.drives.churn import bench_corpus as recipe

    return recipe(n, n_q, d, seed, device="cuda")


def serving_plan(ivf, queries):
    """The probe plan ``IVFIndex.query`` makes with the pipeline's serving
    args (block_q 64, union_factor 1) → (sorted queries, probe list, order,
    block_q): the inputs K1 gets on the main path (with the sentinel
    layout's 1 appended to each query)."""
    from text_similarity_tpu_torch.index.ivf import _plan_probes, _round_up

    block_q = min(64, queries.shape[0])
    n_slabs = ivf.num_base_clusters // ivf.group
    probes = min(ivf.config.num_probes, n_slabs)
    union = min(_round_up(probes, 8), n_slabs)
    q_s, probe_list, order = _plan_probes(
        queries, ivf.centroids, ivf.num_base_clusters, ivf.data_padded.shape[0], block_q, union,
        ivf.group,
    )
    if ivf.sentinel:
        import torch

        q_s = torch.cat([q_s, q_s.new_ones((q_s.shape[0], 1))], dim=1).contiguous()
    return q_s, probe_list, order, block_q


def scan_path(ivf, q_s, probes, block_q, k, w, slots):
    """Which kernel K1 / K4 take for a merge-mode scan (the kernel library's
    plan) and, on the wgmma tile, what it meets: the share of probed slots
    that are live and of its 64-lane tiles that it skips as empty."""
    from text_similarity_tpu_torch.index.ivf import tile_occupancy, tile_plan_cuda
    from text_similarity_tpu_torch.index.ivf_modes import data_kind

    mc = ivf.data_padded.shape[1]
    plan = tile_plan_cuda(data_kind(ivf.data_padded), q_s.shape[1], mc, block_q, k, w or mc,
                          slots if w else 0)
    if plan is None:
        return "CUDA-core kernel", plan
    live, skipped = tile_occupancy(probes, ivf.ids_padded, w or mc)
    return (f"wgmma tile (nq {plan.nq}, {plan.nwg} warpgroups of N {plan.n}, {plan.stages} "
            f"stages; probed slots live {live:.1%}, tiles skipped {skipped:.1%})"), plan


def scan_at_requests(torch, ivf, encode, texts, k, kernel, card):
    """K1 / K4 at the pipeline's request shapes: 1, 5 and 64 of ``texts``,
    encoded and padded as the pipeline pads them, through ``serving_plan``
    (block_q 1, 8 and 64) in the scan mode ``IVFIndex.query`` takes with
    the pipeline's args; each held to the plain version at phase 3's gate
    (|Δscore| ≤ 1e-4, overlap ≥ 0.99) and counted on the wgmma tile."""
    from text_similarity_tpu_torch.index.ivf import ivf_scan_cuda, ivf_scan_reference
    from text_similarity_tpu_torch.pipelines.search import _pad_pow2

    mc = ivf.data_padded.shape[1]
    k_scan = ivf.scan_k(k)
    w, slots = ivf.scan_mode(k_scan, 2048 if mc >= 1024 else 0, 0)
    counter = "launches_tile" if ivf.scales_padded is None else "launches_tile_int8"
    for n in (1, 5, 64):
        qs, probes, _, block_q = serving_plan(ivf, _pad_pow2(encode(texts[:n])))
        args = (qs, probes, ivf.data_padded, ivf.ids_padded, k_scan, block_q, w, slots)
        path, plan = scan_path(ivf, qs, probes, block_q, k_scan, w, slots)
        tiles = getattr(ivf_scan_cuda, counter)
        ks, ki = ivf_scan_cuda(*args, scales=ivf.scales_padded)
        rs, ri = ivf_scan_reference(*args, scales=ivf.scales_padded)
        torch.cuda.synchronize()
        if plan is None or getattr(ivf_scan_cuda, counter) != tiles + 1:
            raise AssertionError(f"{kernel} at a {n}-text request did not run on the wgmma "
                                 f"tile: {path}")
        check_pair(f"{kernel} at a {n}-text request (block_q {block_q}, k_scan {k_scan}, "
                   f"{f'deferred w={w} S={slots}' if w else 'exact'}, on the {path})",
                   ks, ki, rs, ri, card)


def ivf_large_k(torch, card, ivf, queries, kernel, k=300):
    """The large-k route of K1 / K4 (``ivf_scan_large_k_cuda``: the tile's
    emit_acc probe by probe, then the select kernel) in exact mode at k 300
    for a 256-query slice: ``IVFIndex.query`` with the serving args and
    ``approx_width=0`` counted (its scan at k_scan, 600 with the int8
    index's rescore; emit_acc and select launches apart), then the scan
    alone at the path's plan held to the plain scan (overlap ≥ 0.99,
    |Δscore| ≤ 1e-4) and timed. Its bound is the function's own work: the
    live rows of the probed slabs and their ids read once, the queries, the
    (B, k) answer, 2·block_q·D·(live rows of each block's probes)
    operations. The (U, B, Mc) candidates that this design writes and
    reads back are its own overhead, printed apart (``candidates_ms`` at
    the HBM rate), not part of the bound. → (launches dict, row fields)."""
    from text_similarity_tpu_torch.index import ivf_modes
    from text_similarity_tpu_torch.index.ivf import ivf_scan_cuda, ivf_scan_reference

    route = ivf_modes.ivf_scan_large_k_cuda
    qargs = dict(k=k, block_q=64, union_factor=1, approx_width=0)
    route.launches_emit = route.launches_select = 0
    s, i = ivf.query(queries, **qargs)
    torch.cuda.synchronize()
    counts = {"launches": route.launches_emit + route.launches_select,
              "launches_emit": route.launches_emit, "launches_select": route.launches_select}
    live = int((i >= 0).sum(dim=1).min())
    log(f"{kernel} IVFIndex.query at k {k}, exact, {queries.shape[0]} queries: large-k route "
        f"emit_acc launches {counts['launches_emit']}, select launches "
        f"{counts['launches_select']}, answer {tuple(s.shape)}, live results a query ≥ {live}")
    if not (counts["launches_emit"] and counts["launches_select"]) \
            or tuple(s.shape) != (queries.shape[0], k):
        raise AssertionError(f"{kernel} at k {k} did not take the large-k route")
    q_s, probes, _, block_q = serving_plan(ivf, queries)
    args = (q_s, probes, ivf.data_padded, ivf.ids_padded, k, block_q, 0, 1)
    sc = ivf.scales_padded
    ks, ki = ivf_scan_cuda(*args, scales=sc)
    rs, ri = ivf_scan_reference(*args, scales=sc)
    torch.cuda.synchronize()
    n_q, d = q_s.shape
    mc = ivf.data_padded.shape[1]
    u = probes.shape[1]
    ms = time_ms(torch, lambda: ivf_scan_cuda(*args, scales=sc), iters=5, warmup=1)
    err = check_pair(f"{kernel} exact at k {k} through the large-k route (B {n_q}, U {u}, "
                     f"Mc {mc}, block_q {block_q})", ks, ki, rs, ri, card)
    plain = time_ms(torch, lambda: ivf_scan_reference(*args, scales=sc), iters=1, warmup=1)
    ms_query = time_ms(torch, lambda: ivf.query(queries, **qargs), iters=3, warmup=1)
    valid = (ivf.ids_padded >= 0).sum(dim=1)
    slabs = torch.unique(probes[probes >= 0])
    row_bytes = d + 4 if sc is not None else d * 2
    n_bytes = (float(valid[slabs].sum()) * row_bytes + slabs.numel() * mc * 4 + n_q * d * 4
               + n_q * k * 8)
    ops = 2.0 * block_q * d * float(valid[probes[probes >= 0].long()].sum())
    b_ms, b_by = bound_ms(n_bytes, ops, PEAK_BF16)
    cand_ms = 2 * n_q * u * mc * 8 / PEAK_BYTES * 1e3
    log(f"{kernel} large-k times [{card}]: the scan at k {k} {ms:.3f} ms (plain {plain:.3f} ms), "
        f"IVFIndex.query {ms_query:.3f} ms; bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.2f} MB, "
        f"{ops / 1e9:.2f} GFLOP); the design's candidate write and read-back "
        f"{cand_ms:.4f} ms more at the HBM rate")
    return counts, {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                    "bound_by": b_by, "candidates_ms": cand_ms, "ms_query": ms_query,
                    "shape": f"B={n_q} U={u} Mc={mc} D={d} k={k} exact"}


def phase_ivf(torch, card):
    from text_similarity_tpu_torch.core.config import IndexConfig
    from text_similarity_tpu_torch.index.ivf import IVFIndex, ivf_scan_cuda, ivf_scan_reference
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda

    n, n_q, d = 1_000_000, 4096, 384
    corpus, queries = bench_corpus(torch, n, n_q, d)
    cfg = IndexConfig.auto(n)
    torch.cuda.synchronize()
    t0 = time.time()
    ivf = IVFIndex.build(
        corpus, cfg, data_dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0), device="cuda",
    )
    torch.cuda.synchronize()
    build_s = time.time() - t0
    mc = ivf.data_padded.shape[1]
    log(f"IVF build [{card}]: {build_s:.2f} s for {n}x{d}, C={ivf.num_base_clusters} "
        f"(+{ivf.num_overflow} overflow), Mc={mc}, probes={cfg.num_probes}")

    q_s, probes, _, block_q = serving_plan(ivf, queries)
    worst, main, times = 0.0, None, {}
    for k, aw in ((10, 2048), (100, 2048), (10, 0)):
        w, slots = ivf.scan_mode(k, aw, 0)
        mode = f"deferred w={w} S={slots}" if w else "exact"
        args = (q_s, probes, ivf.data_padded, ivf.ids_padded, k, block_q, w, slots)
        path, plan = scan_path(ivf, q_s, probes, block_q, k, w, slots)
        tiles = ivf_scan_cuda.launches_tile
        ks, ki = ivf_scan_cuda(*args)
        rs, ri = ivf_scan_reference(*args)
        torch.cuda.synchronize()
        if plan is None or ivf_scan_cuda.launches_tile != tiles + 1:
            raise AssertionError(f"K1 (bf16, D {d}) did not run on the wgmma tile: {path}")
        ks, ki, rs, ri = (t.cpu().numpy() for t in (ks, ki, rs, ri))
        err = float(np.abs(ks - rs).max())
        worst = max(worst, err)
        ov = overlap(ki, ri)
        ok = ov >= 0.99 and err <= 1e-4
        ms = time_ms(torch, lambda: ivf_scan_cuda(*args), iters=5, warmup=1)
        times[f"k{k}" if w else f"k{k}_exact"] = ms
        log(f"K1 Mc={mc} k={k} mode {mode} on the {path}: overlap {ov:.4f}, max|Δscore| "
            f"{err:.2e}, kernel {ms:.3f} ms [{card}] -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K1 disagrees with its plain version")
        if k == 10 and w:
            plain = time_ms(torch, lambda: ivf_scan_reference(*args), iters=1, warmup=1)
            main = (args, ms, plain, mode)
    if main is None:
        raise AssertionError("the deferred merge did not run at Mc >= 1024")

    # recall@10 of the serving query against the exact top-10 (K2, f32)
    _, exact = cosine_topk_cuda(queries, corpus, 10)
    _, got = ivf.query(queries, k=10, block_q=64, union_factor=1, approx_width=2048)
    recall = overlap(got.cpu().numpy(), exact.cpu().numpy())
    t_q = time_ms(torch, lambda: ivf.query(queries, k=10, block_q=64, union_factor=1,
                                           approx_width=2048), iters=3, warmup=1)
    log(f"IVF recall@10 vs exact: {recall:.4f} (gate 0.95); query 4096 @k=10 "
        f"{t_q:.2f} ms = {n_q / t_q * 1e3:.0f} QPS [{card}]")
    if recall < 0.95:
        raise AssertionError("IVF recall@10 below 0.95")

    args, ms, plain, mode = main
    slabs = torch.unique(args[1])
    valid = (ivf.ids_padded >= 0).sum(dim=1)
    n_bytes = int(valid[slabs].sum()) * d * 2 + slabs.numel() * mc * 4 + n_q * d * 4 + n_q * 10 * 8
    per_block = valid[args[1].long()].sum(dim=1)          # valid slots scanned per block
    ops = 2.0 * block_q * d * float(per_block.sum())
    b_ms, b_by = bound_ms(n_bytes, ops, PEAK_BF16)
    log(f"K1 bound [{card}]: {n_bytes / 1e9:.3f} GB, {ops / 1e9:.1f} GFLOP -> {b_ms:.4f} ms ({b_by})")
    large_launches, large = ivf_large_k(torch, card, ivf, queries[:256].contiguous(), "K1")
    return {
        "large_k": {"name": "ivf_scan_large_k", "route": "cuda",
                    "source": "text_similarity_tpu_torch/csrc/topk_select.cu",
                    "replaces": "text_similarity_tpu/index/ivf.py:1945",
                    "library_ms": None, **large_launches, **large},
        "name": "ivf_scan", "route": "cuda",
        "source": "text_similarity_tpu_torch/csrc/ivf_tile.cu",
        "replaces": "text_similarity_tpu/index/ivf.py:1945",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"B={n_q} U={args[1].shape[1]} Mc={mc} D={d} k=10 {mode} bf16",
        "path": "wgmma tile", "ms_k100": times["k100"], "ms_exact": times["k10_exact"],
    }, (corpus, queries, exact, ivf)


# ---------------------------------------------------------------------------
# Phase 4: the pipeline
# ---------------------------------------------------------------------------

def synthetic_corpus(n, seed=0, n_words=20_000):
    """n unique sentences of 8-40 words over ~20k synthetic words."""
    rng = np.random.default_rng(seed)
    syll = [a + b for a in "bcdfghjklmnprstvwz" for b in "aeiou"]
    words = set()
    while len(words) < n_words:
        words.add("".join(rng.choice(syll, rng.integers(2, 5))))
    words = sorted(words)
    out, seen = [], set()
    while len(out) < n:
        lens = rng.integers(8, 41, n)
        picks = rng.integers(0, len(words), lens.sum())
        pos = 0
        for length in lens:
            s = " ".join(words[j] for j in picks[pos:pos + length])
            pos += length
            if s not in seen:
                seen.add(s)
                out.append(s)
                if len(out) == n:
                    break
    return out


def own_slab_probed(torch, pipe, texts, doc_ids):
    """Per query of one IVF request: is the slab that holds its own document
    in the probe list of its query block? The pipeline's serving args
    (block_q 64, union round_up(probes, 8)) give all queries of a block one
    shared list, so a request of queries from many clusters cannot have
    every query's own slab probed."""
    from text_similarity_tpu_torch.pipelines.search import _pad_pow2

    ivf = pipe.ivf
    mc = ivf.data_padded.shape[1]
    _, probe_list, order, block_q = serving_plan(
        ivf, _pad_pow2(pipe.encoder.encode(texts, device_output=True))
    )
    block_of = torch.argsort(order)[: len(texts)] // block_q
    ids = ivf.ids_padded.reshape(-1)
    slab = torch.full((int(ids.max()) + 1,), -1, dtype=torch.long, device=ids.device)
    live = torch.nonzero(ids >= 0)[:, 0]
    slab[ids[live].long()] = live // mc
    own = slab[torch.as_tensor(np.asarray(doc_ids), device=ids.device)]
    hit = (probe_list[block_of].long() == own[:, None]).any(dim=1)
    return hit.cpu().tolist()


def serve_requests(torch, pipe, label, n_docs, sizes, rng, results, requests):
    """Requests of verbatim corpus sentences → self-retrieval hits (own
    document in the top 10 at score ≥ 0.99) per request size, into
    ``results[(label, size)] = [queries, hits, own slab probed, hits among
    those, [ms]]``; IVF requests also go to ``requests`` for the
    probe-coverage check."""
    picks = rng.choice(n_docs, size=sum(sizes), replace=False)
    start = 0
    for size in sizes:
        req = picks[start:start + size]
        start += size
        texts = [pipe.corpus[j] for j in req]
        torch.cuda.synchronize()
        t = time.time()
        out = pipe(texts, max_num_results=10)
        torch.cuda.synchronize()
        dt = time.time() - t
        hit = [any(d == j and s >= 0.99 for _, s, d in row) for j, row in zip(req, out)]
        if pipe.ivf is not None:
            requests.append((pipe, label, size, texts, req, hit))
        rec = results.setdefault((label, size), [0, 0, 0, 0, []])
        rec[0] += size
        rec[1] += sum(hit)
        rec[4].append(dt * 1e3)


def gate_requests(torch, results, requests, card, probed_only=False):
    """Log each (pipeline, request size) and gate it: ≥ 95% self-retrieval
    on every brute-force request and every single-query IVF request; on a
    multi-query IVF request, ≥ 95% among the queries whose own slab was
    probed. The serving args share one union of round_up(probes, 8) slabs
    across a 64-query block, which cannot hold the own slab of every query
    of a request drawn from many clusters. ``probed_only``: single-query IVF
    requests too are gated among the probed queries (an MoE query, encoded
    alone, routes otherwise than its document did in the corpus's batches,
    and may land in another cluster)."""
    ivf_labels = {label for _, label, *_ in requests}
    for pipe, label, size, texts, req, hit in requests:
        rec = results[(label, size)]
        for probed, h in zip(own_slab_probed(torch, pipe, texts, req), hit):
            rec[2] += probed
            rec[3] += probed and h
    for (label, size), (total, hits, probed, probed_hits, ms) in sorted(results.items()):
        cover = (f"; own slab probed for {probed}/{total}, of which {probed_hits} find "
                 f"themselves" if label in ivf_labels else "")
        log(f"{label}: {len(ms)} request(s) of {size}: {hits}/{total} queries find "
            f"themselves in the top 10 at score >= 0.99{cover}; median {np.median(ms):.1f} ms "
            f"= {size / np.median(ms) * 1e3:.1f} QPS [{card}]")
    for (label, size), (total, hits, probed, probed_hits, _) in results.items():
        if label not in ivf_labels or (size == 1 and not probed_only):
            if hits < 0.95 * total:
                raise AssertionError(f"{label}, requests of {size}: self-retrieval "
                                     f"{hits}/{total} below 95%")
        elif probed_hits < 0.95 * probed or probed == 0:
            raise AssertionError(f"{label}, requests of {size}: self-retrieval "
                                 f"{probed_hits}/{probed} of probed queries below 95%")


def host_ms(torch, fn, reps=5):
    torch.cuda.synchronize()
    t = time.time()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.time() - t) / reps * 1e3


def profile_split(torch, label, fn, card, top=8, groups=(), ranges=()):
    """One call of ``fn`` under ``torch.profiler`` → log its wall time, the
    device's busy and idle share of it (the sum of the device time of every
    kernel, one stream, over the wall time), and the ops that took the most
    device time; with ``groups`` ((label, name substrings), ...) also the
    device time of each group and of the rest; with ``ranges`` (names of
    ``record_function`` ranges) the device time of the kernels launched
    inside each. The profiler's own overhead lengthens the wall time. → {group: device ms, "rest": ms, "busy": ms,
    "wall": ms, "kernels": {device op name: launches}}, or None when the
    profiler saw no device events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t) * 1e3
    # device-side events only (the CPU op that launched a kernel reports the
    # same time again), as the profiler's own table totals them
    ops = [
        (e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
        and e.self_device_time_total > 0
    ]
    busy = sum(ms for ms, _, _ in ops)
    if busy == 0:
        log(f"profile of {label}: wall {wall:.2f} ms; device time not measured "
            f"(the profiler recorded no device events) [{card}]")
        return None
    ops.sort(reverse=True)
    head = "; ".join(f"{key[:60]} x{n} {ms:.3f} ms" for ms, n, key in ops[:top])
    log(f"profile of {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({busy / wall:.1%}), idle {1 - busy / wall:.1%}; top device ops: {head} [{card}]")
    split, rest = {}, busy
    for name, keys in groups:
        ms = sum(t for t, _, key in ops if any(w in key.lower() for w in keys))
        split[name] = ms
        rest -= ms
    for name in ranges:
        ms = sum(e.device_time_total for e in prof.events()
                 if e.name == name and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
        split[name] = ms
        rest -= ms
    if groups or ranges:
        parts = "; ".join(f"{name} {ms:.2f} ms ({ms / busy:.1%})" for name, ms in split.items())
        log(f"profile of {label}, device time by group: {parts}; the rest {rest:.2f} ms "
            f"({rest / busy:.1%}) [{card}]")
    return {**split, "rest": rest, "busy": busy, "wall": wall,
            "kernels": {key: n for _, n, key in ops}}


# bf16 unit embeddings of the 120k corpus, packed route against bucketed:
# about 2.5x the first readings on an H100 (1 − min cosine 6e-6, max|Δ|
# 1.349e-3), where another document's embedding (the control) differs by
# far more: distinct documents' mean cosine is 0.9691
PACK_AGREE_COS, PACK_AGREE_MAX = 1.5e-5, 3.5e-3


def packed_vs_bucketed(torch, enc, corpus, rows, emb_auto, card):
    """The corpus encode bucketed (``packed=False``) beside the ``"auto"``
    route's embeddings ``emb_auto``: its rate, the host time of the packing
    layout alone, and the two routes' agreement (1 − min cosine of the unit
    embeddings and max |Δ| within PACK_AGREE_*), with the bucketed vectors
    rolled by one document as the control, which must lie 100× beyond the
    cosine limit."""
    from text_similarity_tpu_torch.data import (
        BUCKETS, pack_sequences, packing_efficiency, pick_bucket,
    )

    torch.cuda.synchronize()
    t = time.time()
    emb = enc.encode(corpus, batch_size=128, device_output=True, packed=False)
    torch.cuda.synchronize()
    enc_s = time.time() - t
    width = pick_bucket(max(len(r) for r in rows), BUCKETS)
    t = time.time()
    packed = pack_sequences(rows, width, pad_id=enc.tokenizer.pad_id)
    pack_s = time.time() - t
    cos = (emb * emb_auto).sum(dim=1)
    worst = float((emb - emb_auto).abs().max())
    other = emb.roll(1, dims=0)
    ctl_cos = float((other * emb_auto).sum(dim=1).min())
    ctl_max = float((other - emb_auto).abs().max())
    gap = 1.0 - float(cos.min())
    ok = gap <= PACK_AGREE_COS and worst <= PACK_AGREE_MAX and 1.0 - ctl_cos >= 100 * PACK_AGREE_COS
    log(f"encode 120000 docs, packed=False [{card}]: {enc_s:.1f} s = {len(corpus) / enc_s:.0f} "
        f"sentences/s; pack_sequences alone {pack_s * 1e3:.0f} ms ({packed['ids'].shape[0]} rows of "
        f"{width}, {packing_efficiency(packed):.1%} tokens); the two routes' unit embeddings: min "
        f"cosine {float(cos.min()):.7f} (1 − min {gap:.2e}), mean {float(cos.mean()):.7f}, max|Δ| "
        f"{worst:.3e} (limits {PACK_AGREE_COS:.1e}, {PACK_AGREE_MAX:.1e}); control, the next "
        f"document's: min cosine {ctl_cos:.5f}, max|Δ| {ctl_max:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"packed and bucketed encodes disagree (1 − min cosine {gap:.2e}, "
                             f"max|Δ| {worst:.3e}) or the control does not separate them")


def phase_pipeline(torch, card):
    from text_similarity_tpu_torch.core.config import ARCH_PRESETS
    from text_similarity_tpu_torch.data import BUCKETS, pack_sequences, pick_bucket
    from text_similarity_tpu_torch.data.tokenization import (
        WordPieceTokenizer, train_wordpiece_vocab,
    )
    from text_similarity_tpu_torch.index import BruteForceIndex
    from text_similarity_tpu_torch.index.ivf import ivf_scan_cuda
    from text_similarity_tpu_torch.models import SentenceEncoder, init_params
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda, cosine_topk_reference
    from text_similarity_tpu_torch.pipelines import SemanticSearchPipeline
    from text_similarity_tpu_torch.pipelines.search import _pad_pow2

    t0 = time.time()
    corpus = synthetic_corpus(120_000)
    tok = WordPieceTokenizer(train_wordpiece_vocab(corpus, vocab_size=30522))
    arch = ARCH_PRESETS["minilm-l6"]
    params = init_params(arch, torch.Generator().manual_seed(0))
    enc = SentenceEncoder(params, arch, tokenizer=tok, device="cuda")
    log(f"pipeline set-up: corpus + vocab ({tok.vocab_size}) + minilm-l6 init "
        f"{time.time() - t0:.1f} s")

    rng = np.random.default_rng(1)
    results, requests = {}, []

    torch.cuda.synchronize()
    t = time.time()
    big = SemanticSearchPipeline(enc, corpus=corpus, device="cuda")
    torch.cuda.synchronize()
    enc_s = time.time() - t
    rows = enc._tokenize_rows(corpus, 256)
    routes = {True: "packed", False: "bucketed"}
    log(f"encode 120000 docs: {enc_s:.1f} s = {len(corpus) / enc_s:.0f} sentences/s "
        f"(tokenize + minilm-l6 bf16; packed='auto' took the "
        f"{routes[enc.use_packed(rows, big.batch_size, BUCKETS)]} route) [{card}]")
    packed_vs_bucketed(torch, enc, corpus, rows, big.store.view[:len(corpus)], card)
    sample = big.store.view[:2000]
    cos = sample @ sample.T
    log(f"random-weight embeddings: mean cosine between distinct documents "
        f"{float((cos.sum() - cos.diagonal().sum()) / (2000 * 1999)):.4f}")
    t = time.time()
    big._build_ivf()
    torch.cuda.synchronize()
    log(f"IVF build over 120000 docs: {time.time() - t:.2f} s, Mc={big.ivf.data_padded.shape[1]}, "
        f"C={big.ivf.num_base_clusters} (+{big.ivf.num_overflow}) [{card}]")
    small = SemanticSearchPipeline(enc, corpus=corpus[:2000], device="cuda")
    # warm both paths so the counted window holds serving calls only
    big(corpus[:1], 10)
    small(corpus[:1], 10)

    cosine_topk_cuda.launches = 0
    ivf_scan_cuda.launches = ivf_scan_cuda.launches_tile = 0
    serve_requests(torch, big, "ivf pipeline (120000 docs)", len(corpus), [1] * 20 + [5, 64],
                   rng, results, requests)
    serve_requests(torch, small, "brute pipeline (2000 docs)", 2000, [1, 5, 64],
                   rng, results, requests)
    launches = {"cosine_topk": cosine_topk_cuda.launches, "ivf_scan": ivf_scan_cuda.launches}
    k1_tile = ivf_scan_cuda.launches_tile
    log(f"launches during the pipeline phase: {launches}, K1 on the wgmma tile {k1_tile}")

    # repeated 64-query requests on both paths, and where their time goes:
    # encode alone, search alone (the index's query on encoded rows)
    q64 = [corpus[j] for j in rng.choice(2000, 64, replace=False)]
    qe = _pad_pow2(enc.encode(q64, device_output=True))
    mc = big.ivf.data_padded.shape[1]
    enc_ms = host_ms(torch, lambda: enc.encode(q64, device_output=True))
    bucketed_ms = host_ms(torch, lambda: enc.encode(q64, device_output=True, packed=False))
    rows64 = enc._tokenize_rows(q64, 256)
    width64 = pick_bucket(max(len(r) for r in rows64), BUCKETS)
    pack_ms = host_ms(torch, lambda: pack_sequences(rows64, width64, pad_id=enc.tokenizer.pad_id))
    log(f"64-text encode [{card}]: packed='auto' ({routes[enc.use_packed(rows64, 128, BUCKETS)]}) "
        f"{enc_ms:.2f} ms = {64 / enc_ms * 1e3:.0f} sentences/s, packed=False {bucketed_ms:.2f} ms "
        f"= {64 / bucketed_ms * 1e3:.0f} sentences/s; pack_sequences alone {pack_ms:.3f} ms")
    for label, pipe, search in (
        ("ivf pipeline", big, lambda: big.ivf.query(
            qe, k=10, block_q=64, union_factor=1, approx_width=2048 if mc >= 1024 else 0)),
        ("brute pipeline", small, lambda: BruteForceIndex(small.store).query(qe, k=10)),
    ):
        total = host_ms(torch, lambda: pipe(q64, 10))
        log(f"{label}: 64-query request {total:.2f} ms = {64 / total * 1e3:.0f} QPS; "
            f"encode alone {enc_ms:.2f} ms, search alone {host_ms(torch, search):.2f} ms [{card}]")

    # the kernels against their plain versions at the pipeline's shapes
    ks, ki = cosine_topk_cuda(qe, small.store.view.contiguous(), 20)
    rs, ri = cosine_topk_reference(qe, small.store.view, 20)
    torch.cuda.synchronize()
    ov1, e1 = overlap(ki.cpu().numpy(), ri.cpu().numpy()), float((ks - rs).abs().max())
    log(f"at pipeline shapes: K2 (64x{small.store.size}, k=20) overlap {ov1:.4f} max|Δ| {e1:.2e}")
    if ov1 < 0.99 or e1 > 1e-4:
        raise AssertionError("K2 disagrees with its plain version at pipeline shapes")
    scan_at_requests(torch, big.ivf, lambda t: enc.encode(t, device_output=True), q64, 10, "K1",
                     card)

    gate_requests(torch, results, requests, card)
    if launches["cosine_topk"] == 0 or launches["ivf_scan"] == 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if k1_tile != launches["ivf_scan"]:
        raise AssertionError(f"K1 ran {k1_tile} of its {launches['ivf_scan']} launches on the "
                             f"wgmma tile")
    return launches, {"corpus": corpus, "tok": tok, "params": params, "enc": enc,
                      "bf16_store": big.store, "big": big, "small": small}


# ---------------------------------------------------------------------------
# Phase 5: int8 serving
# ---------------------------------------------------------------------------

def phase_int8_topk(torch, card):
    """K3 against its plain version, and its times, at the phase-2 shapes."""
    from text_similarity_tpu_torch.compress.quantize import quantize_embeddings_int8
    from text_similarity_tpu_torch.ops.topk import cosine_topk_int8_cuda, cosine_topk_int8_reference

    corpus, queries = topk_inputs(torch, seed=3)
    n, d = corpus.shape
    codes, scales = quantize_embeddings_int8(corpus)
    worst = 0.0
    # Q 8 and 64 are the pipeline's padded request sizes (query tiles 16 and
    # 64), 256 the 128-query tile, 1 and 7 a tile only partly filled
    for q_n in (1, 7, 8, 64, 256):
        q = queries[:q_n].contiguous()
        for k in (10, 20):
            ks, ki = cosine_topk_int8_cuda(q, codes, scales, k)
            rs, ri = cosine_topk_int8_reference(q, codes, scales, k)
            torch.cuda.synchronize()
            ks, ki, rs, ri = (t.cpu().numpy() for t in (ks, ki, rs, ri))
            err = float(np.abs(ks - rs).max())
            worst = max(worst, err)
            ok = err <= 1e-5 and separated_ids_equal(ki, ri, rs)
            log(f"K3 int8 Q={q_n} k={k}: max|Δscore| {err:.2e}, ids equal "
                f"{np.mean(ki == ri):.4f} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("K3 disagrees with its plain version")
    q, k = queries.contiguous(), 10
    plain = time_ms(torch, lambda: cosine_topk_int8_reference(q, codes, scales, k),
                    iters=3, warmup=1)
    # the pipeline's padded request sizes (the int8 store below 100k
    # documents) and the table's Q 256, each with its bound and the library
    by_q, bound_by_q, lib_by_q = {}, {}, {}
    for q_n in (1, 8, 64, 256):
        qq = q[:q_n].contiguous()
        by_q[q_n] = time_ms(torch, lambda: cosine_topk_int8_cuda(qq, codes, scales, k))
        lib_by_q[q_n] = time_ms(torch, lambda: torch.topk((qq @ codes.float().T) * scales, k, dim=1))
        bound_by_q[q_n] = bound_ms(q_n * d * 4 + n * d + n * 4 + q_n * k * 8, 2.0 * q_n * n * d,
                                   PEAK_F32)
        log(f"K3 int8 Q={q_n} k=10 [{card}]: kernel {by_q[q_n]:.4f} ms, "
            f"torch.topk((q@c.float()T)*s) {lib_by_q[q_n]:.4f} ms, bound "
            f"{bound_by_q[q_n][0]:.4f} ms ({bound_by_q[q_n][1]})")
    ms, lib, (b_ms, b_by) = by_q[256], lib_by_q[256], bound_by_q[256]
    log(f"K3 times [{card}]: int8 Q=256 k=10 kernel {ms:.3f} ms, plain {plain:.3f} ms, "
        f"torch.topk((q@c.float()T)*s) {lib:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    large = int8_brute_large_k(torch, card, corpus, queries[:64].contiguous())
    return {
        "launches_large": large,
        "name": "cosine_topk_int8", "route": "cuda",
        "source": "text_similarity_tpu_torch/csrc/topk.cu",
        "replaces": "text_similarity_tpu/ops/topk.py:617",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "shape": f"Q=256 N={n} D={d} k=10 int8",
        "ms_by_q": by_q, "bound_ms_by_q": {q_n: b for q_n, (b, _) in bound_by_q.items()},
        "library_ms_by_q": lib_by_q,
    }


def int8_brute_large_k(torch, card, corpus, queries, k=200):
    """The int8 ``BruteForceIndex`` over phase 5's corpus at k 200: its 2k
    over-fetch (400) takes K3's large-k route, counted; the answer against
    the plain version (ids equal where the scores are separated, |Δ| ≤
    1e-5). → the route's launches."""
    from text_similarity_tpu_torch.index import BruteForceIndex, EmbeddingStore
    from text_similarity_tpu_torch.ops.topk import (
        cosine_topk_int8_reference, cosine_topk_large_cuda,
    )

    store = EmbeddingStore(corpus.shape[0], corpus.shape[1], quantized=True, device="cuda")
    store.add(corpus)
    codes, scales = store.view, store.scales_view
    cosine_topk_large_cuda.launches_int8 = 0
    s, i = BruteForceIndex(store).query(queries, k=k)
    launches = cosine_topk_large_cuda.launches_int8
    rs, ri = cosine_topk_int8_reference(queries, codes, scales, k + 1)
    rs, ri = rs.cpu().numpy(), ri.cpu().numpy()
    err = float(np.abs(s - rs[:, :k]).max())
    ok = (launches == 1 and err <= 1e-5
          and separated_ids_equal(i, ri[:, :k], rs[:, :k], next_scores=rs[:, k]))
    log(f"int8 BruteForceIndex.query at k {k} (Q {queries.shape[0]}, the 2k over-fetch through "
        f"K3's large-k route): launches {launches}, max|Δscore| {err:.2e} [{card}] -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the int8 brute-force answer at k 200 disagrees with K3's plain "
                             "version, or did not take the large-k route once")
    return launches


def phase_int8_ivf(torch, card, corpus, queries, exact):
    """K4 against its plain version on an int8 index of the phase-3 corpus;
    recall@10 of int8 + rescore (gate) and of raw int8 against exact."""
    import dataclasses

    from text_similarity_tpu_torch.core.config import IndexConfig
    from text_similarity_tpu_torch.index.ivf import IVFIndex, ivf_scan_cuda, ivf_scan_reference

    n, d = corpus.shape
    n_q = queries.shape[0]
    cfg = dataclasses.replace(IndexConfig.auto(n), quantize_int8=True)
    torch.cuda.synchronize()
    t0 = time.time()
    ivf = IVFIndex.build(corpus, cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    mc = ivf.data_padded.shape[1]
    log(f"int8 IVF build [{card}]: {time.time() - t0:.2f} s for {n}x{d}, "
        f"C={ivf.num_base_clusters} (+{ivf.num_overflow}), Mc={mc}, rescore copy "
        f"{str(ivf.rescore_data.dtype)[6:]}")

    q_s, probes, _, block_q = serving_plan(ivf, queries)
    worst, main, times = 0.0, None, {}
    for label, k_scan, aw in (("k=10 raw", 10, 2048), ("k=10 rescore scan", 20, 2048),
                              ("k=10 rescore scan, exact", 20, 0)):
        w, slots = ivf.scan_mode(k_scan, aw, 0)
        mode = f"deferred w={w} S={slots}" if w else "exact"
        args = (q_s, probes, ivf.data_padded, ivf.ids_padded, k_scan, block_q, w, slots)
        path, plan = scan_path(ivf, q_s, probes, block_q, k_scan, w, slots)
        tiles = ivf_scan_cuda.launches_tile_int8
        ks, ki = ivf_scan_cuda(*args, scales=ivf.scales_padded)
        rs, ri = ivf_scan_reference(*args, scales=ivf.scales_padded)
        torch.cuda.synchronize()
        if plan is None or ivf_scan_cuda.launches_tile_int8 != tiles + 1:
            raise AssertionError(f"K4 (D {d}) did not run on the wgmma tile: {path}")
        ks, ki, rs, ri = (t.cpu().numpy() for t in (ks, ki, rs, ri))
        err = float(np.abs(ks - rs).max())
        worst = max(worst, err)
        ov = overlap(ki, ri)
        ok = ov >= 0.99 and err <= 1e-4
        ms = time_ms(torch, lambda: ivf_scan_cuda(*args, scales=ivf.scales_padded),
                     iters=5, warmup=1)
        times[label] = ms
        log(f"K4 Mc={mc} {label} (k_scan {k_scan}) mode {mode} on the {path}: overlap "
            f"{ov:.4f}, max|Δscore| {err:.2e}, kernel {ms:.3f} ms [{card}] -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K4 disagrees with its plain version")
        if k_scan == 20 and w:
            plain = time_ms(torch, lambda: ivf_scan_reference(*args, scales=ivf.scales_padded),
                            iters=1, warmup=1)
            main = (args, ms, plain, mode, slots)
    if main is None or main[4] != 2:
        raise AssertionError("the rescore scan did not run the two-slot deferred fold")

    exact_h = exact.cpu().numpy()
    qargs = dict(k=10, block_q=64, union_factor=1, approx_width=2048)
    recall = {}
    for label, kc in (("int8 + rescore", 0), ("raw int8", -1)):
        _, got = ivf.query(queries, k_coarse=kc, **qargs)
        recall[label] = overlap(got.cpu().numpy(), exact_h)
        t_q = time_ms(torch, lambda: ivf.query(queries, k_coarse=kc, **qargs), iters=3, warmup=1)
        log(f"int8 IVF {label}: recall@10 vs exact {recall[label]:.4f}; query 4096 @k=10 "
            f"{t_q:.2f} ms = {n_q / t_q * 1e3:.0f} QPS [{card}]")
    if recall["int8 + rescore"] < 0.95:
        raise AssertionError("int8 + rescore recall@10 below 0.95")

    args, ms, plain, mode, _ = main
    slabs = torch.unique(args[1])
    valid = (ivf.ids_padded >= 0).sum(dim=1)
    # codes + scale of every valid slot, the ids of every probed slot, the
    # queries once, the (B, k_scan) results
    n_bytes = (int(valid[slabs].sum()) * (d + 4) + slabs.numel() * mc * 4
               + n_q * d * 4 + n_q * args[4] * 8)
    ops = 2.0 * block_q * d * float(valid[args[1].long()].sum())
    b_ms, b_by = bound_ms(n_bytes, ops, PEAK_BF16)
    log(f"K4 bound [{card}]: {n_bytes / 1e9:.3f} GB, {ops / 1e9:.1f} GFLOP -> {b_ms:.4f} ms ({b_by})")
    large_launches, large = ivf_large_k(torch, card, ivf, queries[:256].contiguous(), "K4")
    return {
        "large_k": {f"{key}_int8": v for key, v in {**large_launches, **large}.items()},
        "name": "ivf_scan_int8", "route": "cuda",
        "source": "text_similarity_tpu_torch/csrc/ivf_tile.cu",
        "replaces": "text_similarity_tpu/index/ivf.py:1945 (_ivf_kernel_int8 :1709)",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"B={n_q} U={args[1].shape[1]} Mc={mc} D={d} k_scan=20 {mode} int8",
        "path": "wgmma tile", "ms_exact": times["k=10 rescore scan, exact"],
    }, ivf


def phase_int8_pipeline(torch, card, ctx):
    """The int8 serving path end to end; → the K3/K4 launches of its window."""
    import dataclasses

    from text_similarity_tpu_torch.core.config import IndexConfig
    from text_similarity_tpu_torch.index import BruteForceIndex, EmbeddingStore
    from text_similarity_tpu_torch.index.ivf import ivf_scan_cuda
    from text_similarity_tpu_torch.models import SentenceEncoder
    from text_similarity_tpu_torch.ops.topk import (
        cosine_topk_cuda, cosine_topk_int8_cuda, cosine_topk_int8_reference, l2_normalize,
    )
    from text_similarity_tpu_torch.pipelines import SemanticSearchPipeline
    from text_similarity_tpu_torch.pipelines.search import _pad_pow2

    corpus, enc = ctx["corpus"], ctx["enc"]
    enc8 = SentenceEncoder(ctx["params"], enc.arch, tokenizer=ctx["tok"], device="cuda").to_int8()
    rng = np.random.default_rng(2)
    q64 = [corpus[j] for j in rng.choice(len(corpus), 64, replace=False)]
    e16 = enc.encode(q64, device_output=True)
    e8 = enc8.encode(q64, device_output=True)
    log(f"int8 vs bf16 encoder (minilm-l6, same weights): mean cosine of 64 embeddings "
        f"{float((e16 * e8).sum(dim=1).mean()):.5f}, min {float((e16 * e8).sum(dim=1).min()):.5f}")

    cfg = dataclasses.replace(IndexConfig.auto(len(corpus)), quantize_int8=True)
    torch.cuda.synchronize()
    t = time.time()
    pipe = SemanticSearchPipeline(enc8, corpus=corpus, index_config=cfg, device="cuda")
    torch.cuda.synchronize()
    enc_s = time.time() - t
    log(f"int8 encode 120000 docs: {enc_s:.1f} s = {len(corpus) / enc_s:.0f} sentences/s "
        f"(tokenize + minilm-l6 int8) [{card}]")
    t = time.time()
    pipe._build_ivf()
    torch.cuda.synchronize()
    ivf = pipe.ivf
    log(f"int8 IVF build over 120000 docs: {time.time() - t:.2f} s, Mc={ivf.data_padded.shape[1]}, "
        f"C={ivf.num_base_clusters} (+{ivf.num_overflow}), slabs {str(ivf.data_padded.dtype)[6:]}, "
        f"rescore {str(ivf.rescore_data.dtype)[6:]} [{card}]")
    store8 = EmbeddingStore(2000, enc8.embedding_dim, quantized=True, device="cuda")
    store8.add(pipe.store.view[:2000])
    brute = BruteForceIndex(store8)
    qb = _pad_pow2(enc8.encode(corpus[:64], device_output=True))
    pipe(corpus[:1], 10)        # warm the path outside the counted window
    brute.query(qb, k=10)
    new_doc = "zyx quantized serving check sentence that was never indexed before"
    gone = int(rng.integers(0, len(corpus)))

    results, requests = {}, []
    for counter in ("launches", "launches_int8", "launches_tile", "launches_tile_int8"):
        setattr(ivf_scan_cuda, counter, 0)
    cosine_topk_cuda.launches = 0
    cosine_topk_int8_cuda.launches = 0
    serve_requests(torch, pipe, "int8 ivf pipeline (120000 docs)", len(corpus),
                   [1] * 20 + [5, 64], rng, results, requests)
    new_id = int(pipe.add_documents([new_doc])[0])
    found = pipe([new_doc], 10)[0]
    pipe.remove_documents([gone])
    after = pipe([corpus[gone]], 10)[0]
    s_b, i_b = brute.query(qb, k=10)
    launches = {"cosine_topk_int8": cosine_topk_int8_cuda.launches,
                "ivf_scan_int8": ivf_scan_cuda.launches_int8,
                "cosine_topk": cosine_topk_cuda.launches, "ivf_scan": ivf_scan_cuda.launches}
    k4_tile = ivf_scan_cuda.launches_tile_int8
    log(f"launches during the int8 pipeline window: {launches}, K4 on the wgmma tile {k4_tile}")

    ok_add = bool(found) and found[0][2] == new_id and found[0][1] >= 0.99
    ok_remove = all(d != gone for _, _, d in after)
    log(f"int8 add_documents: new id {new_id} first at score "
        f"{found[0][1] if found else float('nan'):.4f} -> {'ok' if ok_add else 'FAIL'}; "
        f"remove_documents({gone}): absent from its own query's top 10 -> "
        f"{'ok' if ok_remove else 'FAIL'}")
    self_hits = int(sum(i_b[r, 0] == r and s_b[r, 0] >= 0.99 for r in range(64)))
    # the counted K3 launch (Q 64, 2k over-fetch) against its plain version
    # on the same store: BruteForceIndex.query's answer is the first k of it
    rs_b, ri_b = cosine_topk_int8_reference(l2_normalize(qb).float(), store8.view,
                                            store8.scales_view, 20)
    rs_b, ri_b = rs_b[:, :10].cpu().numpy(), ri_b[:, :10].cpu().numpy()
    err_b = float(np.abs(s_b - rs_b).max())
    ok_b = err_b <= 1e-5 and separated_ids_equal(i_b, ri_b, rs_b)
    log(f"BruteForceIndex over an int8 store of 2000 embeddings: {self_hits}/64 verbatim "
        f"queries first at score >= 0.99; its answer (K3, Q 64) against the plain version: "
        f"max|Δscore| {err_b:.2e}, ids equal {np.mean(i_b == ri_b):.4f} -> "
        f"{'ok' if ok_b else 'FAIL'}")

    enc8_ms = host_ms(torch, lambda: enc8.encode(q64, device_output=True))
    qe = _pad_pow2(e8)
    search_ms = host_ms(torch, lambda: ivf.query(qe, k=10, block_q=64, union_factor=1))
    total = host_ms(torch, lambda: pipe(q64, 10))
    log(f"int8 ivf pipeline: 64-query request {total:.2f} ms = {64 / total * 1e3:.0f} QPS; "
        f"int8 encode alone {enc8_ms:.2f} ms, int8 search alone (scan + rescore) "
        f"{search_ms:.2f} ms [{card}]")
    profile_split(torch, "one 64-query int8 request", lambda: pipe(q64, 10), card)
    profile_split(torch, "int8 encode of 64 texts", lambda: enc8.encode(q64, device_output=True),
                  card)
    profile_split(torch, "bf16 encode of the same 64 texts",
                  lambda: enc.encode(q64, device_output=True), card)

    # the kernels against their plain versions at the int8 pipeline's shapes
    ks, ki = cosine_topk_int8_cuda(qb, store8.view, store8.scales_view, 20)
    rs, ri = cosine_topk_int8_reference(qb, store8.view, store8.scales_view, 20)
    torch.cuda.synchronize()
    ov1, e1 = overlap(ki.cpu().numpy(), ri.cpu().numpy()), float((ks - rs).abs().max())
    log(f"at int8 pipeline shapes: K3 (64x2000, k=20) overlap {ov1:.4f} max|Δ| {e1:.2e}")
    if ov1 < 0.99 or e1 > 1e-4:
        raise AssertionError("K3 disagrees with its plain version at pipeline shapes")
    scan_at_requests(torch, ivf, lambda t: enc8.encode(t, device_output=True), q64, 10, "K4",
                     card)

    gate_requests(torch, results, requests, card)
    if not (ok_add and ok_remove):
        raise AssertionError("add_documents / remove_documents on the int8 index failed")
    if self_hits < 0.95 * 64:
        raise AssertionError(f"int8 brute-force self-retrieval {self_hits}/64 below 95%")
    if not ok_b:
        raise AssertionError("BruteForceIndex's int8 answer (K3) disagrees with its plain version")
    if launches["cosine_topk_int8"] == 0 or launches["ivf_scan_int8"] == 0:
        raise AssertionError(f"an int8 kernel of the path never launched: {launches}")
    if k4_tile != launches["ivf_scan_int8"]:
        raise AssertionError(f"K4 ran {k4_tile} of its {launches['ivf_scan_int8']} launches on "
                             f"the wgmma tile")
    return launches


# ---------------------------------------------------------------------------
# Phase 5b: the IVF index's other layouts and scan modes
# ---------------------------------------------------------------------------

K100_ARGS = dict(union_factor=1, block_q=64, approx_width=512)   # bench.py's k = 100 args
QARGS = dict(union_factor=1, block_q=64, approx_width=2048)      # bench.py's k = 10 args


def scan_bound(torch, ivf, probes, n_q, block_q, out_bytes, with_ids=True):
    """K1's bound for a scan of ``probes`` (B/block_q, U): every valid slot
    of the probed slabs read once (codes + scale for int8), the ids of
    every probed slab (none for the idless scan), the queries once, the
    mode's output; the dot products of every block against its valid slots
    (bf16 tensor-core rate)."""
    d = ivf.data_padded.shape[-1]
    mc = ivf.data_padded.shape[1]
    row = d * ivf.data_padded.element_size() + (4 if ivf.scales_padded is not None else 0)
    slabs = torch.unique(probes)
    valid = (ivf.ids_padded >= 0).sum(dim=1)
    n_bytes = (int(valid[slabs].sum()) * row + (slabs.numel() * mc * 4 if with_ids else 0)
               + n_q * d * 4 + out_bytes)
    ops = 2.0 * block_q * d * float(valid[probes.long()].sum())
    return bound_ms(n_bytes, ops, PEAK_BF16)


def emit_acc_select(q, probes, data, ids, k, block_q, width, slots):
    """K1-opt emit_acc's raw accumulator at (width, S), then its exact
    top-k by (score desc, id asc) → (scores, ids). Where the wgmma tile
    takes the shape, emit_acc is K1's deferred mode on the tile, so this is
    K1 on the tile bit for bit; elsewhere it is K1's CUDA-core emit_acc
    kernel (the same pass and fmaf chain as K1's CUDA-core fold)."""
    from text_similarity_tpu_torch.index.ivf import ivf_scan_cuda
    from text_similarity_tpu_torch.index.ivf_modes import _select

    acc_s, acc_i = ivf_scan_cuda(q, probes, data, ids, k, block_q, width, slots, emit_acc=True)
    return _select(acc_s, acc_i, k)


def bit_equal(a, b) -> bool:
    """Two (scores, ids) results equal bit for bit."""
    return a[0].equal(b[0]) and a[1].equal(b[1])


def check_pair(label, ks, ki, rs, ri, card, ms=None, k1_ms=None):
    """A kernel's (scores, ids) against its plain version's: f32 |Δscore| ≤
    1e-4 (phase 3's gate) and id overlap ≥ 0.99 → max |Δ|."""
    ks, ki, rs, ri = (t.reshape(-1, t.shape[-1]).cpu().numpy() for t in (ks, ki, rs, ri))
    # an empty result (−1) at rank j counts as its own id, so that tails agree
    col = np.arange(ki.shape[1])
    ki, ri = np.where(ki < 0, -1 - col, ki), np.where(ri < 0, -1 - col, ri)
    fin = np.isfinite(rs)
    err = float(np.abs(ks[fin] - rs[fin]).max()) if fin.any() else 0.0
    ov = overlap(ki, ri)
    ok = ov >= 0.99 and err <= 1e-4 and np.array_equal(np.isfinite(ks), fin)
    times = f", kernel {ms:.3f} ms (K1 at the same k {k1_ms:.3f} ms)" if ms is not None else ""
    log(f"{label}: overlap {ov:.4f}, max|Δscore| {err:.2e}{times} [{card}] "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def phase_ivf_options(torch, card, ivf, ivf8, corpus, queries, exact):
    """Every scan option of ``IVFIndex.query`` on the phase-3 bf16 index, the
    phase-5 int8 + rescore index, a sentinel and a group-2 bf16 build of the
    same corpus: the options through ``query`` (the counted window), recall
    against K2's exact top-10 / top-100, then each kernel (K1-opt, K9, K10,
    K11a, K11b) against its plain version at the shapes ``query`` gives it,
    timed beside K1. → the kernels' JSON entries."""
    from text_similarity_tpu_torch.index import ivf_modes
    from text_similarity_tpu_torch.index.ivf import (
        IVFIndex, _round_up, ivf_scan_cuda, ivf_scan_reference,
    )
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda, l2_normalize

    n, d = corpus.shape
    n_q = queries.shape[0]
    _, exact100 = cosine_topk_cuda(queries, corpus, 100)
    exact10, exact100 = exact.cpu().numpy(), exact100.cpu().numpy()
    builds = {}
    for name, opts in (("sentinel", dict(sentinel=True)), ("group2", dict(group=2))):
        torch.cuda.synchronize()
        t0 = time.time()
        builds[name] = IVFIndex.build(
            corpus, ivf.config, data_dtype=torch.bfloat16, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(0), **opts)
        torch.cuda.synchronize()
        b = builds[name]
        log(f"IVF build {name} [{card}]: {time.time() - t0:.2f} s, slabs "
            f"{tuple(b.data_padded.shape)} {str(b.data_padded.dtype)[6:]}, C={b.num_base_clusters} "
            f"(+{b.num_overflow} overflow slabs), Mc={b.cluster_cap}")
    sent, grp = builds["sentinel"], builds["group2"]
    u_main = min(_round_up(min(ivf.config.num_probes, ivf.num_base_clusters), 8),
                 ivf.num_base_clusters) + ivf.num_overflow
    log(f"probe union U at 1M (with {ivf.num_overflow} overflow slabs): {u_main} "
        f"(the packed fold needs U <= 64, Mc <= 2048: Mc={ivf.data_padded.shape[1]})")
    if u_main > 64:
        raise AssertionError("the bench index overflows the packed fold's 64 probes")

    # --- the main path: IVFIndex.query with every option (counted window)
    counters = [(ivf_scan_cuda, c) for c in (
        "launches", "launches_int8", "launches_per_probe", "launches_per_probe_int8",
        "launches_per_probe_tile", "launches_per_probe_tile_int8",
        "launches_emit_acc", "launches_emit_acc_int8", "launches_emit_acc_tile",
        "launches_emit_acc_tile_int8")] + [
        (getattr(ivf_modes, f"ivf_scan_{m}_cuda"), "launches")
        for m in ("packed", "dma", "multiprobe", "idless")] + [
        (getattr(ivf_modes, f"ivf_scan_{m}_cuda"), "launches_tile")
        for m in ("packed", "dma", "multiprobe", "idless")]
    q10 = dict(QARGS)
    per_probe_args = dict(union_factor=1, block_q=64, per_probe=True)
    cases = [
        ("per_probe bf16 k=10", ivf, 10, per_probe_args),
        ("per_probe int8 + rescore k=10 (k_coarse 20)", ivf8, 10, dict(per_probe_args, k_coarse=20)),
        ("final_merge xla bf16 k=100", ivf, 100, dict(K100_ARGS, final_merge="xla")),
        ("final_merge xla_approx bf16 k=100", ivf, 100, dict(K100_ARGS, final_merge="xla_approx")),
        ("final_merge xla int8 + rescore k=100", ivf8, 100, dict(K100_ARGS, final_merge="xla")),
        ("final_merge xla_approx int8 + rescore k=100", ivf8, 100,
         dict(K100_ARGS, final_merge="xla_approx")),
        ("final_merge packed k=10", ivf, 10, dict(q10, final_merge="packed")),
        ("final_merge packed k=100", ivf, 100, dict(K100_ARGS, final_merge="packed")),
        *[(f"dma_pipeline buffers {nb} k=10", ivf, 10, dict(q10, dma_pipeline=True, dma_buffers=nb))
          for nb in (2, 3, 4)],
        ("dma_pipeline k=100", ivf, 100, dict(K100_ARGS, dma_pipeline=True)),
        *[(f"probes_per_step {p} k=10", ivf, 10, dict(q10, probes_per_step=p)) for p in (2, 3, 4)],
        ("sentinel idless k=10", sent, 10, dict(q10, acc_slots=1)),
        ("sentinel k=100 (K1 over D+1 slabs)", sent, 100, dict(K100_ARGS)),
        ("group2 k=10", grp, 10, dict(q10)),
    ]
    rng = np.random.default_rng(5)
    gone = int(exact10[0, 0])
    new_row = l2_normalize(torch.from_numpy(rng.standard_normal((1, d)).astype(np.float32)).cuda())
    for obj, attr in counters:
        setattr(obj, attr, 0)
    results = []
    for label, index, k, args in cases:
        results.append((label, k, *index.query(queries, k=k, **args)))
    sent.remove([gone])
    _, after = sent.query(queries[:64], k=10, acc_slots=1, **q10)
    new_id = int(sent.add(new_row, start_id=n)[0])
    s_new, i_new = sent.query(new_row, k=10, acc_slots=1, **q10)
    torch.cuda.synchronize()
    counts = {f"{getattr(obj, '__name__', '')}.{attr}": getattr(obj, attr) for obj, attr in counters}
    log(f"launches during the IVF options window: {counts}")

    for label, k, s, i in results:
        want = exact10 if k == 10 else exact100
        rec = overlap(i.cpu().numpy(), want)
        log(f"IVF {label}: recall@{k} vs exact {rec:.4f} (gate 0.95), scores finite "
            f"{bool(torch.isfinite(s).all())} [{card}]")
        if rec < 0.95:
            raise AssertionError(f"IVF {label}: recall@{k} below 0.95")
    ok_remove = not (after == gone).any().item()
    ok_add = int(i_new[0, 0]) == new_id and float(s_new[0, 0]) >= 0.99
    log(f"sentinel remove({gone}): absent from 64 queries' top 10 -> "
        f"{'ok' if ok_remove else 'FAIL'}; add: new id {new_id} first at "
        f"{float(s_new[0, 0]):.4f} -> {'ok' if ok_add else 'FAIL'}")
    if not (ok_remove and ok_add):
        raise AssertionError("remove / add on the sentinel index failed")
    for key in ("ivf_scan_cuda.launches_per_probe", "ivf_scan_cuda.launches_per_probe_int8",
                "ivf_scan_cuda.launches_emit_acc", "ivf_scan_cuda.launches_emit_acc_int8",
                "ivf_scan_packed_cuda.launches", "ivf_scan_dma_cuda.launches",
                "ivf_scan_multiprobe_cuda.launches", "ivf_scan_idless_cuda.launches",
                "ivf_scan_cuda.launches"):
        if counts[key] == 0:
            raise AssertionError(f"{key} never launched on the IVF options path")
    # per_probe and emit_acc (bf16 and int8), K9, K10 and K11a on the bf16
    # index and K11b on the sentinel build run the wgmma tile
    tile_counts = [(f"K1-opt {m}", sum(counts[f"ivf_scan_cuda.launches_{m}_tile{x}"]
                                       for x in ("", "_int8")),
                    sum(counts[f"ivf_scan_cuda.launches_{m}{x}"] for x in ("", "_int8")))
                   for m in ("per_probe", "emit_acc")]
    tile_counts += [(f"ivf_scan_{m}_cuda", counts[f"ivf_scan_{m}_cuda.launches_tile"],
                     counts[f"ivf_scan_{m}_cuda.launches"])
                    for m in ("packed", "dma", "multiprobe", "idless")]
    for name, on_tile, launched in tile_counts:
        log(f"{name}: {on_tile} of {launched} launches on the wgmma tile (csrc/ivf_tile.cu)")
        if on_tile != launched:
            raise AssertionError(f"{name} left the wgmma tile on the options path")

    # --- each kernel against its plain version at the shapes query gives it
    # (QARGS and K100_ARGS plan as the serving args: block_q 64, union_factor 1)
    def timed(fn, plain_fn):
        return (time_ms(torch, fn, iters=5, warmup=1),
                time_ms(torch, plain_fn, iters=1, warmup=1))

    mc = ivf.data_padded.shape[1]
    qs, pl, _, bq = serving_plan(ivf, queries)
    data, ids = ivf.data_padded, ivf.ids_padded
    k1_10 = time_ms(torch, lambda: ivf_scan_cuda(qs, pl, data, ids, 10, bq, mc, 1), iters=5, warmup=1)
    entries = []

    def entry(name, source, replaces, err, ms, plain, bnd, shape, launches):
        entries.append({"name": name, "route": "cuda", "source": f"text_similarity_tpu_torch/csrc/{source}",
                        "replaces": f"text_similarity_tpu/index/ivf.py:{replaces}",
                        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
                        "shape": shape})
        log(f"{name} [{card}]: {ms:.3f} ms, plain {plain:.3f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}), {ms / bnd[0]:.1f}x the bound; {shape}")

    # K1-opt per_probe (bf16, and int8 at the rescore's k) on the wgmma
    # tile: each probe's top-k pooled to (B, U·k) and selected is K1's
    # (K4's) exact mode on the tile, bit for bit
    a = (qs, pl, data, ids, 10, bq)
    qs8, pl8, _, _ = serving_plan(ivf8, queries)
    a8 = (qs8, pl8, ivf8.data_padded, ivf8.ids_padded, 10, bq)
    u = pl.shape[1]
    errs, pp_ms = [], {}
    for label, args, sc in (("bf16", a, None), ("int8", a8, ivf8.scales_padded)):
        tiles = ivf_scan_cuda.launches_per_probe_tile + ivf_scan_cuda.launches_per_probe_tile_int8
        ks, ki = ivf_scan_cuda(*args, scales=sc, per_probe=True)
        if (ivf_scan_cuda.launches_per_probe_tile + ivf_scan_cuda.launches_per_probe_tile_int8
                != tiles + 1):
            raise AssertionError(f"K1-opt per_probe {label} left the wgmma tile at the main "
                                 f"path's shape")
        rs, ri = ivf_scan_reference(*args, scales=sc, per_probe=True)
        b = ks.shape[1]
        pooled = ivf_modes._select(ks.permute(1, 0, 2).reshape(b, -1),
                                   ki.permute(1, 0, 2).reshape(b, -1), 10)
        bit = bit_equal(pooled, ivf_scan_cuda(*args, scales=sc))
        pp_ms[label] = time_ms(torch, lambda: ivf_scan_cuda(*args, scales=sc, per_probe=True),
                               iters=5, warmup=1)
        k1_exact = time_ms(torch, lambda: ivf_scan_cuda(*args, scales=sc), iters=5, warmup=1)
        k1 = "K1" if sc is None else "K4"
        errs.append(check_pair(f"K1-opt per_probe {label} k=10 on the wgmma tile, kernel "
                               f"{pp_ms[label]:.3f} ms ({k1}'s exact mode on the tile "
                               f"{k1_exact:.3f} ms; pooled and selected, bit for bit equal to "
                               f"it: {bit})", ks, ki, rs, ri, card))
        if not bit:
            raise AssertionError(f"K1-opt per_probe {label}, pooled and selected, differs from "
                                 f"the exact mode on the wgmma tile")
    plain = time_ms(torch, lambda: ivf_scan_reference(*a, per_probe=True), iters=1, warmup=1)
    entry("ivf_scan_per_probe", "ivf_tile.cu", "1945 (per_probe :1130-1132, :1238-1240, :1908-1917)",
          max(errs), pp_ms["bf16"], plain, scan_bound(torch, ivf, pl, n_q, bq, u * n_q * 10 * 8),
          f"B={n_q} U={u} Mc={mc} D={d} k=10 bf16 -> (U, B, k) on the wgmma tile; int8 timed too",
          counts["ivf_scan_cuda.launches_per_probe"] + counts["ivf_scan_cuda.launches_per_probe_int8"])
    entries[-1]["ms_by_case"] = pp_ms
    entries[-1]["bound_ms_by_case"] = {
        "bf16": entries[-1]["bound_ms"],
        "int8": scan_bound(torch, ivf8, pl8, n_q, bq, u * n_q * 10 * 8)[0]}

    # K1-opt emit_acc at k = 100 (bench's w 512 and the planned slots) and,
    # int8, at the rescore's k_scan 200, on the wgmma tile: after the exact
    # select, equal to K1 on the tile at the same (w, S) bit for bit
    w, slots = ivf.scan_mode(100, 512, final_merge="xla")
    a = (qs, pl, data, ids, 100, bq, w, slots)
    w8, s8 = ivf8.scan_mode(200, 512, final_merge="xla")
    b8 = (qs8, pl8, ivf8.data_padded, ivf8.ids_padded, 200, bq, w8, s8, ivf8.scales_padded)
    tiles = ivf_scan_cuda.launches_emit_acc_tile + ivf_scan_cuda.launches_emit_acc_tile_int8
    ks, ki = ivf_scan_cuda(*a, emit_acc=True)
    ks8, ki8 = ivf_scan_cuda(*b8, emit_acc=True)
    if ivf_scan_cuda.launches_emit_acc_tile + ivf_scan_cuda.launches_emit_acc_tile_int8 != tiles + 2:
        raise AssertionError("K1-opt emit_acc left the wgmma tile at the main path's shape")
    bits = (bit_equal(ivf_modes._select(ks, ki, 100), ivf_scan_cuda(*a)),
            bit_equal(ivf_modes._select(ks8, ki8, 200), ivf_scan_cuda(*b8)))
    rs, ri = ivf_scan_reference(*a, emit_acc=True)
    rs8, ri8 = ivf_scan_reference(*b8, emit_acc=True)
    ms, plain = timed(lambda: ivf_scan_cuda(*a, emit_acc=True),
                      lambda: ivf_scan_reference(*a, emit_acc=True))
    ms8 = time_ms(torch, lambda: ivf_scan_cuda(*b8, emit_acc=True), iters=5, warmup=1)
    k1_100 = time_ms(torch, lambda: ivf_scan_cuda(*a), iters=5, warmup=1)
    errs = []
    for label, tms, (es, ei, gs, gi) in (
            (f"bf16 k=100 w={w} S={slots}", ms, (ks, ki, rs, ri)),
            (f"int8 k_scan=200 w={w8} S={s8}", ms8, (ks8, ki8, rs8, ri8))):
        same = ei == gi
        errs.append((float(same.float().mean()),
                     float((es - gs)[same & torch.isfinite(gs)].abs().max())))
        log(f"K1-opt emit_acc {label} on the wgmma tile: accumulator entries equal "
            f"{errs[-1][0]:.5f}, max|Δscore| {errs[-1][1]:.2e}, kernel {tms:.3f} ms [{card}]")
    log(f"K1-opt emit_acc + exact select equal to K1 on the wgmma tile at the same (w, S) bit "
        f"for bit: bf16 {bits[0]}, int8 {bits[1]} (K1 at k=100 {k1_100:.3f} ms) [{card}]")
    if min(e[0] for e in errs) < 0.99 or max(e[1] for e in errs) > 1e-4:
        raise AssertionError("K1-opt emit_acc disagrees with its plain version")
    if not all(bits):
        raise AssertionError("K1-opt emit_acc + select differs from K1 on the wgmma tile")
    entry("ivf_scan_emit_acc", "ivf_tile.cu", "1945 (emit_acc :1212-1222, :1919)",
          max(e[1] for e in errs), ms, plain, scan_bound(torch, ivf, pl, n_q, bq, n_q * slots * w * 8),
          f"B={n_q} U={pl.shape[1]} Mc={mc} D={d} w={w} S={slots} bf16 -> (B, S*w) on the wgmma "
          f"tile; int8 k_scan 200 timed too",
          counts["ivf_scan_cuda.launches_emit_acc"] + counts["ivf_scan_cuda.launches_emit_acc_int8"])
    entries[-1]["ms_by_case"] = {"bf16_k100": ms, "int8_k200": ms8}
    entries[-1]["bound_ms_by_case"] = {
        "bf16_k100": entries[-1]["bound_ms"],
        "int8_k200": scan_bound(torch, ivf8, pl8, n_q, bq, n_q * s8 * w8 * 8)[0]}

    # K9 packed, k = 10 (w = Mc) and k = 100 (w 512, the planned slots), on
    # the wgmma tile
    bin_w = 1.0 / ivf_modes.PACK_SCALE + 1e-6
    worst, main, k9_ms, k9_bound = 0.0, None, {}, {}
    for k, args in ((10, QARGS), (100, K100_ARGS)):
        qk, plk = qs, pl
        wk, sk = ivf.scan_mode(k, args["approx_width"], final_merge="packed")
        a = (qk, plk, data, ids, k, bq, wk, sk)
        tiles = ivf_modes.ivf_scan_packed_cuda.launches_tile
        kp = ivf_modes.ivf_scan_packed_cuda(*a)
        if ivf_modes.ivf_scan_packed_cuda.launches_tile != tiles + 1:
            raise AssertionError("K9 left the wgmma tile at the main path's shape")
        rp = ivf_modes.ivf_scan_packed_reference(*a)
        ks, ki = ivf_modes._unpack_candidates(kp, plk, ids, bq)
        rs, ri = ivf_modes._unpack_candidates(rp, plk, ids, bq)
        ov = overlap(ki.cpu().numpy(), ri.cpu().numpy())
        e = float((ks.sort(dim=1).values - rs.sort(dim=1).values).abs().max())
        bits = float((kp == rp).float().mean())
        ms = time_ms(torch, lambda: ivf_modes.ivf_scan_packed_cuda(*a), iters=5, warmup=1)
        k9_ms[f"k{k}"] = ms
        k9_bound[f"k{k}"] = scan_bound(torch, ivf, plk, n_q, bq, n_q * k * 4)[0]
        ok = ov >= 0.99 and e <= bin_w
        log(f"K9 packed k={k} w={wk} S={sk} on the wgmma tile: overlap {ov:.4f}, unpacked "
            f"max|Δscore| {e:.2e} "
            f"(one bin {bin_w:.2e}), packets bit-equal {bits:.5f}, kernel {ms:.3f} ms "
            f"(K1 at the same k {k1_10 if k == 10 else k1_100:.3f} ms) [{card}] -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K9 disagrees with its plain version")
        worst = max(worst, e)
        if k == 10:
            plain = time_ms(torch, lambda: ivf_modes.ivf_scan_packed_reference(*a), iters=1, warmup=1)
            main = (ms, plain, plk, wk, sk)
    ms, plain, plk, wk, sk = main
    entry("ivf_scan_packed", "ivf_tile.cu", "1505", worst, ms, plain,
          scan_bound(torch, ivf, plk, n_q, bq, n_q * 10 * 4),
          f"B={n_q} U={plk.shape[1]} Mc={mc} D={d} k=10 w={wk} S={sk} bf16 -> (B, k) packets on "
          f"the wgmma tile; k=100 timed too", counts["ivf_scan_packed_cuda.launches"])
    entries[-1]["ms_by_case"] = k9_ms
    entries[-1]["bound_ms_by_case"] = k9_bound

    # K10: full width, the planned slots, buffers 2-4, on K1's wgmma tile:
    # equal to K1 at (Mc, S) and to emit_acc + the exact select there (the
    # same tile), bit for bit
    worst, main, k10_ms = 0.0, None, {}
    for k, nbs in ((10, (2, 3, 4)), (100, (2,))):
        _, sk = ivf.scan_mode(k, dma_pipeline=True)
        k1 = ivf_scan_cuda(qs, pl, data, ids, k, bq, mc, sk)
        fold = emit_acc_select(qs, pl, data, ids, k, bq, mc, sk)
        rs, ri = ivf_modes.ivf_scan_dma_reference(qs, pl, data, ids, k, bq, sk)
        k1_ms = time_ms(torch, lambda: ivf_scan_cuda(qs, pl, data, ids, k, bq, mc, sk), iters=5, warmup=1)
        for nb in nbs:
            tiles = ivf_modes.ivf_scan_dma_cuda.launches_tile
            got = ivf_modes.ivf_scan_dma_cuda(qs, pl, data, ids, k, bq, sk, nb)
            if ivf_modes.ivf_scan_dma_cuda.launches_tile == tiles:
                raise AssertionError("K10 left the wgmma tile at the main path's shape")
            stages = ivf_modes.tile_plan_cuda(1, d, mc, bq, k, mc, sk, nb).stages
            bit, bit_fold = bit_equal(got, k1), bit_equal(got, fold)
            ms = time_ms(torch, lambda: ivf_modes.ivf_scan_dma_cuda(qs, pl, data, ids, k, bq, sk, nb),
                         iters=5, warmup=1)
            k10_ms[f"k{k}_buffers{nb}"] = ms
            worst = max(worst, check_pair(f"K10 dma k={k} S={sk} buffers {nb} on the wgmma tile "
                                          f"(ivf_tile.cu), {stages} stages (bit for bit equal to K1 "
                                          f"at (Mc, S): {bit}; to emit_acc + select: {bit_fold})",
                                          *got, rs, ri, card, ms, k1_ms))
            if not (bit and bit_fold):
                raise AssertionError("K10 differs from K1 at (approx_width = Mc, acc_slots = S)")
            if k == 10 and nb == 2:
                plain = time_ms(torch, lambda: ivf_modes.ivf_scan_dma_reference(
                    qs, pl, data, ids, k, bq, sk), iters=1, warmup=1)
                main = (ms, plain, sk)
    ms, plain, sk = main
    entry("ivf_scan_dma", "ivf_tile.cu", "1682", worst, ms, plain,
          scan_bound(torch, ivf, pl, n_q, bq, n_q * 10 * 8),
          f"B={n_q} U={pl.shape[1]} Mc={mc} D={d} k=10 S={sk} buffers 2 bf16 on the wgmma tile "
          f"(3, 4 and k=100 timed too)", counts["ivf_scan_dma_cuda.launches"])
    entries[-1]["ms_by_case"] = k10_ms

    # K11a: P = 2, 3 (the list padded), 4, on K1's wgmma tile: equal to K1
    # at (Mc, 1) and to emit_acc + the exact select there, bit for bit
    worst, main, k11a_ms = 0.0, None, {}
    k1 = ivf_scan_cuda(qs, pl, data, ids, 10, bq, mc, 1)
    fold = emit_acc_select(qs, pl, data, ids, 10, bq, mc, 1)
    for p in (2, 3, 4):
        tiles = ivf_modes.ivf_scan_multiprobe_cuda.launches_tile
        got = ivf_modes.ivf_scan_multiprobe_cuda(qs, pl, data, ids, 10, bq, p)
        if ivf_modes.ivf_scan_multiprobe_cuda.launches_tile == tiles:
            raise AssertionError("K11a left the wgmma tile at the main path's shape")
        rs, ri = ivf_modes.ivf_scan_multiprobe_reference(qs, pl, data, ids, 10, bq, p)
        bit, bit_fold = bit_equal(got, k1), bit_equal(got, fold)
        ms = time_ms(torch, lambda: ivf_modes.ivf_scan_multiprobe_cuda(qs, pl, data, ids, 10, bq, p),
                     iters=5, warmup=1)
        k11a_ms[f"P{p}"] = ms
        worst = max(worst, check_pair(f"K11a probes_per_step {p} k=10 on the wgmma tile "
                                      f"(ivf_tile.cu) (bit for bit equal to K1 at (Mc, 1): {bit}; "
                                      f"to emit_acc + select: {bit_fold})", *got, rs, ri, card, ms,
                                      k1_10))
        if not (bit and bit_fold):
            raise AssertionError("K11a differs from K1 at (approx_width = Mc, acc_slots = 1)")
        if p == 2:
            plain = time_ms(torch, lambda: ivf_modes.ivf_scan_multiprobe_reference(
                qs, pl, data, ids, 10, bq, 2), iters=1, warmup=1)
            main = (ms, plain)
    ms, plain = main
    entry("ivf_scan_multiprobe", "ivf_tile.cu", "1870", worst, ms, plain,
          scan_bound(torch, ivf, pl, n_q, bq, n_q * 10 * 8),
          f"B={n_q} U={pl.shape[1]} Mc={mc} D={d} k=10 P=2 bf16 on the wgmma tile (3, 4 timed too)",
          counts["ivf_scan_multiprobe_cuda.launches"])
    entries[-1]["ms_by_case"] = k11a_ms

    # K11b on the sentinel build (D+1 = 385) on the wgmma tile, its
    # skipped share, and K1 over its 385-wide slabs
    qsn, pln, _, _ = serving_plan(sent, queries)
    mcs = sent.data_padded.shape[1]
    ws = sent.scan_mode(10, 2048, 1)[0]
    a = (qsn, pln, sent.data_padded, 10, bq, ws)
    zt = sent.zero_tiles
    tile_counts = torch.zeros(2, dtype=torch.int32, device="cuda")
    tiles = ivf_modes.ivf_scan_idless_cuda.launches_tile
    ks, ki = ivf_modes.ivf_scan_idless_cuda(*a, zt, tile_counts)
    rs, ri = ivf_modes.ivf_scan_idless_reference(*a)
    on_tile = ivf_modes.ivf_scan_idless_cuda.launches_tile > tiles
    listed, skipped = (int(v) for v in tile_counts.cpu())
    ms, plain = timed(lambda: ivf_modes.ivf_scan_idless_cuda(*a, zt),
                      lambda: ivf_modes.ivf_scan_idless_reference(*a))
    k1_s = time_ms(torch, lambda: ivf_scan_cuda(qsn, pln, sent.data_padded, sent.ids_padded, 10,
                                                bq, ws, 1), iters=5, warmup=1)
    err = check_pair(f"K11b idless k=10 w={ws} D+1={d + 1} on the "
                     f"{'wgmma tile (ivf_tile.cu)' if on_tile else 'CUDA-core kernel (ivf_scan.cu)'}: "
                     f"{skipped} of {listed} probed tiles skipped "
                     f"({skipped / max(listed, 1):.1%}, all rows zero)", ks, ki, rs, ri, card, ms, k1_s)
    if not on_tile:
        raise AssertionError("K11b left the wgmma tile on the sentinel build")
    qsn5, pln5 = qsn, pln
    w5, s5 = sent.scan_mode(100, 512, 0)
    b5 = (qsn5, pln5, sent.data_padded, sent.ids_padded, 100, bq, w5, s5)
    ks5, ki5 = ivf_scan_cuda(*b5)
    rs5, ri5 = ivf_scan_reference(*b5)
    fold5 = emit_acc_select(*b5)
    bit5 = bit_equal((ks5, ki5), fold5)
    check_pair(f"K1 over D+1={d + 1} slabs k=100 w={w5} S={s5} (its CUDA-core kernel; equal to "
               f"that kernel's fold, emit_acc + top-k, bit for bit: {bit5})", ks5, ki5, rs5, ri5,
               card)
    if not bit5:
        raise AssertionError("K1's CUDA-core merge differs from its own fold (emit_acc + top-k)")
    entry("ivf_scan_idless", "ivf_tile.cu", "1809", err, ms, plain,
          scan_bound(torch, sent, pln, n_q, bq, n_q * 10 * 8, with_ids=False),
          f"B={n_q} U={pln.shape[1]} Mc={mcs} D+1={d + 1} k=10 w={ws} bf16 -> flat slot ids, on "
          f"the wgmma tile, {skipped / max(listed, 1):.3f} of its probed tiles skipped",
          counts["ivf_scan_idless_cuda.launches"])

    # end to end: each option's query rate at 4096 queries
    for label, index, k, args in cases:
        if "buffers 3" in label or "buffers 4" in label or "xla_approx" in label:
            continue
        t_q = time_ms(torch, lambda: index.query(queries, k=k, **args), iters=2, warmup=1)
        log(f"IVFIndex.query {label}: {t_q:.2f} ms = {n_q / t_q * 1e3:.0f} QPS [{card}]")
    del builds, sent, grp
    return entries


# ---------------------------------------------------------------------------
# Phase 6: long documents
# ---------------------------------------------------------------------------

LONG_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
# bf16 last_hidden_state, K5 path against the banded reference path, valid
# rows: about 2.5x the largest readings on an H100 (roberta-base-long mean
# 7.9e-3, max 0.117; minilm-l6 window 0 mean 2.8e-3, max 0.070), where
# another document's rows differ by a mean of 0.52-0.63
AGREE_MEAN, AGREE_MAX = 2e-2, 0.3
FLASH_GROUPS = (("K5 flash_fwd", ("flash_fwd",)),
                ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass")))


def band_pairs(lens, window, global_cls):
    """(query, key) pairs one head's attention needs: valid rows i < len
    against valid keys j < len in the band |i − j| ≤ window (every valid key
    at window 0), plus the CLS row and column with ``global_cls``."""
    total = 0
    for n in lens:
        if n <= 0:
            continue
        if window <= 0:
            total += n * n
            continue
        i = np.arange(n)
        cnt = np.minimum(i + window, n - 1) - np.maximum(i - window, 0) + 1
        if global_cls:
            cnt[0] = n                  # the CLS row sees every valid key
            cnt[1:] += i[1:] > window   # key 0 outside the band of row i
        total += int(cnt.sum())
    return total


def flash_case(torch, q, k, v, lengths, window, cls):
    """K5 and its plain version on one input → (max |Δ| and mean |Δ| of the
    outputs on valid rows, max |Δ| of lse there, zero-length rows exactly
    0)."""
    from text_similarity_tpu_torch.ops.attention import flash_attention_cuda, flash_attention_plain

    out, lse = flash_attention_cuda(q, k, v, lengths, window, cls, return_lse=True)
    ref, ref_lse = flash_attention_plain(q, k, v, lengths, window, cls, return_lse=True)
    torch.cuda.synchronize()
    valid = torch.arange(q.shape[1], device=q.device)[None, :] < lengths[:, None]
    diff = (out.float() - ref.float()).abs()[valid]
    lse_err = float((lse - ref_lse).abs().transpose(1, 2)[valid].max())
    zero = lengths == 0
    zero_ok = bool((out[zero] == 0).all()) and bool((lse[zero] == 0).all())
    return float(diff.max()), float(diff.mean()), lse_err, zero_ok


def phase_flash(torch, card):
    """K5 against its plain version (B 8 × S 4096 × H 12, D 64 and D 32,
    lengths 3001-4096; B 3 × S 512 × D 32 with a zero-length row; f32 and bf16;
    window 0, 256, 256 + global CLS; q, k, v as views of a fused QKV), then
    its times at the serving shape beside the plain version and SDPA."""
    import torch.nn.functional as F

    from text_similarity_tpu_torch.ops.attention import flash_attention_cuda, flash_attention_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    worst = 0.0
    long_lens = (4096, 3001, 4090, 3500, 3800, 3100, 4000, 3333)
    for b, s, h, d, lens in ((8, 4096, 12, 64, long_lens), (8, 4096, 12, 32, long_lens),
                             (3, 512, 12, 32, (512, 300, 0))):
        qkv = torch.randn(b, s, h, 3, d, generator=g, device=dev)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = qkv.to(dtype)
            q, k, v = x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]
            for window, cls in ((0, False), (256, False), (256, True)):
                err, mean, lse_err, zero_ok = flash_case(torch, q, k, v, lengths, window, cls)
                worst = max(worst, err)
                if dtype == torch.float32:
                    ok = err <= 1e-4
                else:
                    ok = err <= 1e-2 and mean <= 5e-4
                ok = ok and lse_err <= 1e-4 and zero_ok
                log(f"K5 {str(dtype)[6:]} B={b} S={s} D={d} lens={lens} window={window} "
                    f"cls={cls}: max|Δ| {err:.2e}, mean|Δ| {mean:.2e}, lse max|Δ| "
                    f"{lse_err:.2e}, zero rows exact {zero_ok} -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("K5 disagrees with its plain version")

    # times at the serving shape: roberta-base-long's attention, one batch
    b, s, h, d = 8, 4096, 12, 64
    x = torch.randn(b, s, h, 3, d, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]
    lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pos = torch.arange(s, device=dev)
    times = {}
    for window, cls in ((256, True), (0, False)):
        allowed = None
        if window:
            allowed = (pos[:, None] - pos[None, :]).abs() <= window
            allowed |= (pos[:, None] == 0) | (pos[None, :] == 0)
        ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v, lengths, window, cls))
        plain = time_ms(torch, lambda: flash_attention_plain(q, k, v, lengths, window, cls),
                        iters=2, warmup=1)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed))
        sdpa_err = float((F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed)
                          .transpose(1, 2).float()
                          - flash_attention_cuda(q, k, v, lengths, window, cls).float())
                         .abs().max())
        pairs = h * band_pairs([s] * b, window, cls)
        n_bytes = 4 * b * s * h * d * 2 + b * 4
        b_ms, b_by = bound_ms(n_bytes, 4.0 * d * pairs, PEAK_BF16)
        log(f"K5 times [{card}]: bf16 B={b} S={s} H={h} D={d} window={window} cls={cls}: kernel "
            f"{ms:.3f} ms, plain {plain:.3f} ms, SDPA (bool mask) {lib:.3f} ms (max|Δ| vs "
            f"kernel {sdpa_err:.2e}), bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e9:.3f} GB, "
            f"{4.0 * d * pairs / 1e9:.1f} GFLOP; {pairs} pairs)")
        times[window] = (ms, plain, lib, b_ms, b_by)
    ms, plain, lib, b_ms, b_by = times[256]
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "text_similarity_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "text_similarity_tpu/ops/attention.py:253 (:272 with lse)",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "ms_window0": times[0][0], "library_ms_window0": times[0][2],
        "bound_ms_window0": times[0][3],
        "shape": f"B={b} S={s} H={h} D={d} window=256 global CLS bf16",
    }


def long_documents(tok, sentences, rng, n_long, n_short):
    """Documents joined from corpus sentences: n_long of 3000-4040 tokens,
    then n_short of 600-980 (sentences are added until the drawn length is
    reached; one adds at most 40 tokens)."""
    counts = [len(r) for r in tok.tokenize_many(sentences)]
    targets = list(rng.integers(3000, 4001, n_long)) + list(rng.integers(600, 941, n_short))
    docs, pos = [], 0
    for target in targets:
        parts, n = [], 0
        while n < target:
            parts.append(sentences[pos % len(sentences)])
            n += counts[pos % len(sentences)]
            pos += 1
        docs.append(" ".join(parts))
    return docs


def bucket_batches(enc, docs, batch_size, max_len=4096):
    """(bucket, row lengths) of each batch that ``encode`` forms: rows
    sorted by token length, grouped by batch_size, each batch padded to the
    bucket of its longest row."""
    from text_similarity_tpu_torch.data.batching import pick_bucket

    lens = sorted(len(r) for r in enc._tokenize_rows(docs, max_len))
    groups = [lens[i:i + batch_size] for i in range(0, len(lens), batch_size)]
    return [(pick_bucket(rows[-1], LONG_BUCKETS), rows) for rows in groups]


def path_agreement(torch, enc, texts, bucket=4096, paths=None):
    """One batch of texts padded to ``bucket`` through ``encoder_forward``
    on two paths, the one under test and the one it is held to: ``paths``
    gives each as (encoder, attention_impl); by default ``enc`` with
    attention_impl "auto" (K5 in every layer at 4096 on the card) against
    ``enc`` with "reference" (the banded reference). → (mean |Δ| and max |Δ|
    of last_hidden_state on valid rows; the mean |Δ| between each
    document's rows on the first path and the next document's on the
    second, which is what an answer for the wrong document would give; min
    cosine of the pooled unit embeddings)."""
    import torch.nn.functional as F

    from text_similarity_tpu_torch.models import encoder_forward
    from text_similarity_tpu_torch.models.pooling import pool

    rows = enc._tokenize_rows(texts, bucket)
    ids = np.full((len(rows), bucket), enc.tokenizer.pad_id, np.int32)
    mask = np.zeros((len(rows), bucket), np.int32)
    for r, row in enumerate(rows):
        ids[r, :len(row)], mask[r, :len(row)] = row, 1
    ids, mask = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    hidden, emb = [], []
    with torch.no_grad():
        for e, impl in paths or ((enc, "auto"), (enc, "reference")):
            h = encoder_forward(e.params, ids, mask, arch=e.arch, precision=e.precision,
                                attention_impl=impl).last_hidden_state
            hidden.append(h.float())
            emb.append(F.normalize(pool(e.pooling, h, mask).float(), dim=-1))
    valid = mask.bool()
    diff = (hidden[0] - hidden[1]).abs()[valid]
    both = valid & valid.roll(1, 0)
    control = (hidden[0] - hidden[1].roll(1, 0)).abs()[both]
    cos = (emb[0] * emb[1]).sum(dim=1)
    return float(diff.mean()), float(diff.max()), float(control.mean()), float(cos.min())


def phase_long_documents(torch, card, ctx):
    """roberta-base converted for 4096 tokens (positions tiled to 4098,
    band 256, global CLS; random weights, bf16) encodes 128 documents with
    the long-encode arguments into a store searched by K2; → K5's launches
    in that encode (K2's launches in the search are gated here)."""
    from text_similarity_tpu_torch.core.config import ARCH_PRESETS
    from text_similarity_tpu_torch.index import BruteForceIndex, EmbeddingStore
    from text_similarity_tpu_torch.models import SentenceEncoder, init_params
    from text_similarity_tpu_torch.models.hf_convert import extend_positions
    from text_similarity_tpu_torch.ops.attention import flash_attention_cuda
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda

    tok, corpus = ctx["tok"], ctx["corpus"]
    rng = np.random.default_rng(6)
    # packed=False: "auto" already runs the windowed model bucketed, but it
    # could pack the window-0 minilm-l6 below, whose 4096-wide packed rows
    # would run segment-masked plain attention instead of K5
    kw = dict(max_len=4096, buckets=LONG_BUCKETS, batch_size=8, packed=False)
    t0 = time.time()
    docs = long_documents(tok, corpus[:24_000], rng, 112, 16)
    arch = ARCH_PRESETS["roberta-base"]
    params, arch = extend_positions(init_params(arch, torch.Generator().manual_seed(0)), arch, 4098)
    arch = arch.replace(attention_window=256, window_global_cls=True)
    enc = SentenceEncoder(params, arch, tokenizer=tok, device="cuda")
    batches = bucket_batches(enc, docs, 8)
    n_4096 = sum(bucket == 4096 for bucket, _ in batches)
    n_tokens = sum(sum(rows) for _, rows in batches)
    log(f"long set-up: {len(docs)} documents ({n_tokens} tokens; batches of 8 at buckets "
        f"{[bucket for bucket, _ in batches]}), roberta-base-long init "
        f"{time.time() - t0:.1f} s")
    enc.encode(docs[:8], **kw)           # warm the path outside the counted window

    flash_attention_cuda.launches = 0
    cosine_topk_cuda.launches = 0
    torch.cuda.synchronize()
    t = time.time()
    emb = enc.encode(docs, device_output=True, **kw)
    torch.cuda.synchronize()
    enc_s = time.time() - t
    launches = flash_attention_cuda.launches
    log(f"long encode [{card}]: {len(docs)} documents in {enc_s:.2f} s = "
        f"{len(docs) / enc_s:.1f} docs/s, {n_tokens / enc_s:.0f} tokens/s (tokenize + "
        f"roberta-base-long bf16); K5 launches {launches} (12 layers x {n_4096} batches at 4096)")

    store = EmbeddingStore(len(docs), enc.embedding_dim, device="cuda")
    store.add(emb)
    index = BruteForceIndex(store)
    picks = rng.choice(len(docs), 16, replace=False)
    scores, ids = index.query(enc.encode([docs[j] for j in picks], device_output=True, **kw), k=10)
    hits = sum(any(i == j and sc >= 0.99 for sc, i in zip(srow, irow))
               for j, srow, irow in zip(picks, scores, ids))
    k2_launches = cosine_topk_cuda.launches
    n = len(docs)
    cos = emb @ emb.T
    log(f"long self-retrieval (K2 launches {k2_launches}): {hits}/16 documents find themselves "
        f"in the top 10 at score "
        f">= 0.99; mean cosine between distinct documents "
        f"{float((cos.sum() - cos.diagonal().sum()) / (n * (n - 1))):.5f}")

    # the same encoder through the banded reference on the card
    rows = enc._tokenize_rows(docs, 4096)
    long_idx = [j for j in range(n) if len(rows[j]) > 2048][:8]
    agree = path_agreement(torch, enc, [docs[j] for j in long_idx])
    log(f"K5 path against the reference path (8 documents at bucket 4096): last_hidden_state "
        f"on valid rows mean|Δ| {agree[0]:.3e}, max|Δ| {agree[1]:.3e} (another document's "
        f"rows: mean|Δ| {agree[2]:.3e}); pooled min cosine {agree[3]:.6f}")
    profile_split(torch, "one 8 x 4096 roberta-base-long encode",
                  lambda: enc.encode([docs[j] for j in long_idx], device_output=True, **kw),
                  card, groups=FLASH_GROUPS)

    # window 0 on the path: minilm-l6 with positions tiled to 4096, full attention
    march = ARCH_PRESETS["minilm-l6"]
    mparams, march = extend_positions(ctx["params"], march, 4096)
    menc = SentenceEncoder(mparams, march, tokenizer=tok, device="cuda")
    mdocs = [docs[j] for j in long_idx] + [docs[j] for j in range(n) if len(rows[j]) > 2048][8:16]
    m_4096 = sum(bucket == 4096 for bucket, _ in bucket_batches(menc, mdocs, 8))
    before = flash_attention_cuda.launches
    torch.cuda.synchronize()
    t = time.time()
    memb = menc.encode(mdocs, device_output=True, **kw)
    torch.cuda.synchronize()
    m_s = time.time() - t
    m_launches = flash_attention_cuda.launches - before
    m_agree = path_agreement(torch, menc, mdocs[:8])
    log(f"minilm-l6 at 4096, window 0 [{card}]: {len(mdocs)} documents in {m_s:.2f} s; K5 "
        f"launches {m_launches} (6 layers x {m_4096} batches at 4096); against the reference "
        f"path: last_hidden_state mean|Δ| {m_agree[0]:.3e}, max|Δ| {m_agree[1]:.3e} (another "
        f"document's rows: mean|Δ| {m_agree[2]:.3e}); pooled min cosine {m_agree[3]:.6f}")

    finite = bool(torch.isfinite(emb).all()) and bool(torch.isfinite(memb).all())
    unit = float((emb.norm(dim=1) - 1).abs().max())
    if not finite or emb.shape != (n, 768) or unit > 1e-4:
        raise AssertionError(f"long embeddings: finite {finite}, shape {tuple(emb.shape)}, "
                             f"max |norm - 1| {unit:.2e}")
    if launches != 12 * n_4096 or n_4096 == 0:
        raise AssertionError(f"K5 launched {launches} times, expected 12 x {n_4096}")
    if k2_launches == 0:
        raise AssertionError("K2 never launched in the search over the long-document store")
    if m_launches != 6 * m_4096 or m_4096 == 0:
        raise AssertionError(f"K5 (window 0) launched {m_launches} times, expected 6 x {m_4096}")
    if hits < 0.95 * 16:
        raise AssertionError(f"long self-retrieval {hits}/16 below 95%")
    for name, (mean, worst, control, cos) in (("roberta-base-long", agree),
                                                ("minilm-l6 window 0", m_agree)):
        if mean > AGREE_MEAN or worst > AGREE_MAX or cos < 0.99:
            raise AssertionError(f"{name}: the K5 path and the reference path disagree "
                                 f"(mean|Δ| {mean:.3e}, max|Δ| {worst:.3e}, min cosine {cos:.6f})")
        if control < 10 * AGREE_MEAN:
            raise AssertionError(f"{name}: another document's rows differ by only {control:.3e}; "
                                 f"the agreement gate could not tell them apart")
    return launches


# ---------------------------------------------------------------------------
# Phase 7: training (K6)
# ---------------------------------------------------------------------------

TRAIN_BUCKET = 4096
# K6 against its plain version, every row: |Δ| ≤ REL · max(1, |ref|) (dv
# of the CLS key sums over 4096 rows and reaches |ref| ≈ 110). f32: 1e-4.
# bf16: two bf16 ulps (2 · 2^-7), where the largest H100 reading is 4.7e-3
# here and 6.7e-3 in the card tests (0.86 ulp: one rounding of ds, p or the
# output turned the other way); mean |Δ| at 2.5x the largest reading, 2.4e-7
K6_F32_REL, K6_BF16_REL, K6_BF16_MEAN = 1e-4, 2 * 2.0 ** -7, 6e-7
# per-leaf relative gradient difference, K5/K6 path against the reference
# path (2-layer roberta-base-long, one pair at 4096): bf16 at about 2.5x the
# first H100 reading (worst leaf 1.23e-2, the key kernel; median 2.8e-3;
# f32 2.7e-6), where another pair's gradient differs by 0.63
GRAD_F32, GRAD_BF16 = 1e-3, 3e-2
TRAIN_GROUPS = (("K5 flash_fwd", ("flash_fwd",)), ("K6 flash_bwd", ("flash_bwd",)),
                ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass")))


def k6_case(torch, q, k, v, lengths, window, cls, g):
    """K5's o and lse and a random do (nonzero on padded rows too), then K6
    and its plain version → (max |Δ|, mean |Δ|, largest |Δ| / max(1, |ref|))
    over dq, dk, dv on every row, and zero-length rows exactly 0."""
    from text_similarity_tpu_torch.ops.attention import (
        flash_attention_backward_cuda, flash_attention_backward_plain, flash_attention_cuda,
    )

    out, lse = flash_attention_cuda(q, k, v, lengths, window, cls, return_lse=True)
    do = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
    got = flash_attention_backward_cuda(q, k, v, lengths, out, lse, do, window, cls)
    want = flash_attention_backward_plain(q, k, v, lengths, out, lse, do, window, cls)
    torch.cuda.synchronize()
    worst = mean = rel = 0.0
    zero_ok = True
    for x, y in zip(got, want):
        diff = (x.float() - y.float()).abs()
        worst = max(worst, float(diff.max()))
        mean = max(mean, float(diff.mean()))
        rel = max(rel, float((diff / y.float().abs().clamp_min(1.0)).max()))
        zero_ok = zero_ok and bool((x[lengths == 0] == 0).all())
    return worst, mean, rel, zero_ok


def k6_pairs(lens, window, global_cls):
    """The (query, key) pairs K6 computes for one head: every row i < S
    (padded rows too: their lse is real) against the kept keys j < len."""
    return sum(band_pairs([n], window, global_cls) for n in lens)


def phase_flash_backward(torch, card):
    """K6 against its plain version (B 4 × S 4096 × H 12 with D 64 and D 32,
    lengths 3001-4096; B 3 × S 512 × D 32 with a zero-length row; f32 and
    bf16; window 0, 256, 256 + global CLS; q, k, v as views of a fused QKV),
    then its times at the training shape beside the plain version and SDPA's
    backward."""
    import torch.nn.functional as F

    from text_similarity_tpu_torch.ops.attention import (
        flash_attention_backward_cuda, flash_attention_backward_plain, flash_attention_cuda,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    worst = 0.0
    long_lens = (4096, 3001, 3500, 4040)
    for b, s, h, d, lens in ((4, 4096, 12, 64, long_lens), (4, 4096, 12, 32, long_lens),
                             (3, 512, 12, 32, (512, 300, 0))):
        qkv = torch.randn(b, s, h, 3, d, generator=g, device=dev)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = qkv.to(dtype)
            q, k, v = x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]
            for window, cls in ((0, False), (256, False), (256, True)):
                err, mean, rel, zero_ok = k6_case(torch, q, k, v, lengths, window, cls, g)
                worst = max(worst, err)
                if dtype == torch.float32:
                    ok = rel <= K6_F32_REL
                else:
                    ok = rel <= K6_BF16_REL and mean <= K6_BF16_MEAN
                ok = ok and zero_ok
                log(f"K6 {str(dtype)[6:]} B={b} S={s} D={d} lens={lens} window={window} "
                    f"cls={cls}: dq/dk/dv max|Δ| {err:.3e}, mean|Δ| {mean:.3e}, max|Δ|/max(1,|ref|) "
                    f"{rel:.3e}, zero rows exact {zero_ok} -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("K6 disagrees with its plain version")

    # times at the training shape: roberta-base-long's attention, 4 sequences
    b, s, h, d = 4, TRAIN_BUCKET, 12, 64
    x = torch.randn(b, s, h, 3, d, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]
    lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    do = torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)
    pos = torch.arange(s, device=dev)
    times = {}
    for window, cls in ((256, True), (0, False)):
        out, lse = flash_attention_cuda(q, k, v, lengths, window, cls, return_lse=True)
        args = (q, k, v, lengths, out, lse, do, window, cls)
        ms = time_ms(torch, lambda: flash_attention_backward_cuda(*args))
        plain = time_ms(torch, lambda: flash_attention_backward_plain(*args), iters=2, warmup=1)
        allowed = None
        if window:
            allowed = (pos[:, None] - pos[None, :]).abs() <= window
            allowed |= (pos[:, None] == 0) | (pos[None, :] == 0)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed)
            torch.autograd.grad(o, (qt, kt, vt), dot)

        lib = time_ms(torch, sdpa_fwd_bwd) - time_ms(torch, sdpa_fwd)
        pairs = h * k6_pairs([s] * b, window, cls)
        # the function reads q, k, v, o, do and lse once and writes dq, dk,
        # dv once; per kept pair the backward needs five products of D
        # multiply-adds (s = q·kᵀ, dp = do·vᵀ, dq, dk, dv): 10·D operations.
        # The two kernels recompute s and dp once more (14·D), which the
        # function itself does not need, so that is logged beside the bound.
        n_bytes = 8 * b * s * h * d * 2 + b * h * s * 4 + b * 4
        ops = 10.0 * d * pairs
        b_ms, b_by = bound_ms(n_bytes, ops, PEAK_BF16)
        log(f"K6 times [{card}]: bf16 B={b} S={s} H={h} D={d} window={window} cls={cls}: "
            f"kernels (dq with di, then dk/dv) {ms:.3f} ms, plain {plain:.3f} ms, SDPA "
            f"backward (fwd+bwd − fwd, bool mask) {lib:.3f} ms, bound {b_ms:.4f} ms ({b_by}: "
            f"{n_bytes / 1e9:.3f} GB, {ops / 1e9:.1f} GFLOP; {pairs} pairs); the kernels' own "
            f"products with the recompute: {1.4 * ops / 1e9:.1f} GFLOP, "
            f"{1.4 * ops / PEAK_BF16 * 1e3:.4f} ms")
        times[window] = (ms, plain, lib, b_ms, b_by)
    ms, plain, lib, b_ms, b_by = times[256]
    return {
        "name": "flash_attention_backward", "route": "cuda",
        "source": "text_similarity_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "text_similarity_tpu/ops/attention.py:469 (dq), :498 (dk/dv)",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "ms_window0": times[0][0], "library_ms_window0": times[0][2],
        "bound_ms_window0": times[0][3],
        "shape": f"B={b} S={s} H={h} D={d} window=256 global CLS bf16",
    }


def document_pairs(tok, sentences, rng, n, lengths=(3000, 4001)):
    """n pairs (a document of ``lengths`` tokens, 3000-4000 by default,
    joined from corpus sentences, the same sentences in another order)."""
    counts = [len(r) for r in tok.tokenize_many(sentences)]
    pairs, pos = [], 0
    for target in rng.integers(*lengths, n):
        parts, total = [], 0
        while total < target:
            parts.append(sentences[pos % len(sentences)])
            total += counts[pos % len(sentences)]
            pos += 1
        shuffled = [parts[j] for j in rng.permutation(len(parts))]
        pairs.append((" ".join(parts), " ".join(shuffled)))
    return pairs


def flat_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flat_leaves(v, path) if isinstance(v, dict) else {path: v})
    return out


def zeros_like_tree(torch, tree):
    return {k: zeros_like_tree(torch, v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def long_arch_params(torch, layers=None):
    """roberta-base converted as phase 6 converts it (random weights, seed
    0; positions tiled to 4098; window 256, global CLS), optionally cut to
    its first ``layers`` layers."""
    from text_similarity_tpu_torch.core.config import ARCH_PRESETS
    from text_similarity_tpu_torch.models import init_params
    from text_similarity_tpu_torch.models.hf_convert import extend_positions

    arch = ARCH_PRESETS["roberta-base"]
    params, arch = extend_positions(init_params(arch, torch.Generator().manual_seed(0)), arch, 4098)
    arch = arch.replace(attention_window=256, window_global_cls=True)
    if layers:
        def cut(t):
            return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) else t[:layers]

        params["layers"] = cut(params["layers"])
        arch = arch.replace(num_layers=layers)
    return params, arch


def phase_long_training(torch, card, ctx):
    """roberta-base-long trains for two epochs of 4 batches (MNRL, 4 pairs
    at bucket 4096) through ``Trainer.execute`` with prefetch, as
    ``_run_bi_encoder_training`` composes the calls → (K5's and K6's
    launches in that run, the pairs, the tokenizer)."""
    from text_similarity_tpu_torch.core.config import TrainConfig
    from text_similarity_tpu_torch.data.pairs import build_pair_batches
    from text_similarity_tpu_torch.models import SentenceEncoder
    from text_similarity_tpu_torch.ops.attention import (
        flash_attention_backward_cuda, flash_attention_cuda,
    )
    from text_similarity_tpu_torch.train import (
        Trainer, init_train_state, make_bi_encoder_train_step, make_optimizer,
    )
    from text_similarity_tpu_torch.train.steps import batch_to

    tok, corpus = ctx["tok"], ctx["corpus"]
    rng = np.random.default_rng(7)
    t0 = time.time()
    pairs = document_pairs(tok, corpus[:24_000], rng, 16)
    params, arch = long_arch_params(torch)
    enc = SentenceEncoder(params, arch, tokenizer=tok, device="cuda")
    batches = build_pair_batches(tok, pairs, np.zeros(len(pairs), np.float32), batch_size=4,
                                 max_len=TRAIN_BUCKET)
    widths = sorted({b["ids_a"].shape[1] for b in batches})
    n_tokens = int(sum(b["mask_a"].sum() + b["mask_b"].sum() for b in batches))
    cfg = TrainConfig(lr=2e-5, warmup_ratio=0.1)
    epochs = 2
    total = len(batches) * epochs
    tx = make_optimizer(cfg, total, params_example={"encoder": enc.params})
    state = init_train_state({"encoder": enc.params}, tx, seed=cfg.seed, device="cuda")
    step = make_bi_encoder_train_step(arch, tx, loss_type="mnrl", pooling=enc.pooling)
    log(f"long training set-up: {len(pairs)} pairs in {len(batches)} batches of 4 at widths "
        f"{widths} ({n_tokens} real tokens an epoch), roberta-base-long (f32 master weights, bf16 "
        f"compute, hidden dropout {arch.hidden_dropout}) {time.time() - t0:.1f} s")

    snap = {k: v.detach().clone() for k, v in flat_leaves(state.params).items()}
    seen = {"losses": [], "same": {}, "t": {}}

    def watched(st, batch):
        st, metrics = step(st, batch)
        seen["losses"].append(metrics["loss"])
        if st.step in (1, 2):
            seen["same"][st.step] = all(torch.equal(v, snap[k])
                                        for k, v in flat_leaves(st.params).items())
        if st.step == len(batches):          # the end of the first epoch
            torch.cuda.synchronize()
            seen["t"]["epoch1"] = time.time()
        return st, metrics

    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = 0
    flash_attention_backward_cuda.launches = 0
    trainer = Trainer(watched, state, log_every=len(batches), device="cuda")
    result = trainer.execute(lambda e: iter(batches), epochs=epochs)
    torch.cuda.synchronize()
    t_end = time.time()
    launches = {"K5": flash_attention_cuda.launches, "K6": flash_attention_backward_cuda.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in seen["losses"]]
    epoch2 = t_end - seen["t"]["epoch1"]
    log(f"long training [{card}]: {total} steps, losses {[f'{x:.4f}' for x in losses]}; epoch 2 "
        f"{epoch2:.3f} s = {len(pairs) / epoch2:.2f} pairs/s, {n_tokens / epoch2:.0f} tokens/s; "
        f"peak memory {peak:.2f} GiB; launches {launches} (K5 expected 12 x 2 towers x {total} = "
        f"{12 * 2 * total}, K6 2 x that); params unchanged by step 1: {seen['same'].get(1)}, "
        f"by step 2: {seen['same'].get(2)}")

    # where one step's time goes (after the counted run)
    state = result["state"]
    batch = batch_to(batches[0], torch.device("cuda"))
    split = profile_split(torch, "one roberta-base-long training step (4 pairs at 4096)",
                          lambda: step(state, batch), card, groups=TRAIN_GROUPS)
    zeros = zeros_like_tree(torch, state.params)
    opt_ms = time_ms(torch, lambda: tx.step(state.params, zeros, state.opt_state), iters=3, warmup=1)
    n_params = sum(v.numel() for v in flat_leaves(state.params).values())
    log(f"optimizer step alone (clip + AdamW over {n_params} parameters): {opt_ms:.3f} ms [{card}]")
    if split is not None:
        rest = split["rest"] - opt_ms
        log(f"training step split [{card}]: K5 {split['K5 flash_fwd']:.2f} ms, K6 "
            f"{split['K6 flash_bwd']:.2f} ms, GEMMs {split['GEMMs']:.2f} ms, optimizer "
            f"{opt_ms:.2f} ms (timed alone), elementwise and the rest {rest:.2f} ms "
            f"({rest / split['busy']:.1%}); device busy {split['busy']:.2f} of "
            f"{split['wall']:.2f} ms wall, idle {1 - split['busy'] / split['wall']:.1%}")

    if not all(np.isfinite(losses)) or len(losses) != total:
        raise AssertionError(f"long training losses: {losses}")
    if launches["K5"] != 12 * 2 * total or launches["K6"] != 2 * 12 * 2 * total:
        raise AssertionError(f"K5/K6 launched {launches}, expected {12 * 2 * total} and "
                             f"{2 * 12 * 2 * total}")
    if seen["same"].get(1) is not True or seen["same"].get(2) is not False:
        raise AssertionError(f"parameters after steps 1 and 2: unchanged {seen['same']} (step 1 "
                             f"has lr 0 and must move nothing; step 2 must move them)")
    return launches["K6"], pairs


def grad_rel(a, b):
    """Per leaf ‖a − b‖ / ‖b‖ of two flat gradient trees (‖b‖ floored at
    1e-3 of the whole gradient's norm; those leaves are named), and over
    all leaves."""
    norms = {k: float(ref.norm()) for k, ref in b.items()}
    whole = sum(n * n for n in norms.values()) ** 0.5
    out, floored, num = {}, [], 0.0
    for k, ref in b.items():
        d = float((a[k] - ref).norm())
        num += d * d
        if norms[k] < 1e-3 * whole:
            floored.append(k)
        out[k] = d / max(norms[k], 1e-3 * whole)
    return out, num ** 0.5 / whole, floored


def phase_grad_agreement(torch, card, tok, pairs):
    """A 2-layer cut of roberta-base-long at full width, one pair at 4096:
    the gradient of a fixed random projection of both towers'
    ``last_hidden_state`` (one random vector per position, valid tokens)
    through ``attention_impl="auto"`` (K5 forward, K6 backward) against the
    banded reference path, per leaf ‖g_auto − g_ref‖ / ‖g_ref‖, in f32 and
    bf16; the gradient of another pair is the control. (With random
    weights a pair loss is ill-conditioned here, since a document and its
    shuffle pool to cosine 0.9996, and any loss of the pooled vectors gives
    nearly the same gradient for every document.) A leaf whose gradient is
    zero in exact arithmetic (the key bias: a shift shared by a row's
    scores leaves the softmax alone) is measured against 1e-3 of the whole
    gradient's norm instead of its own."""
    from text_similarity_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from text_similarity_tpu_torch.data.pairs import build_pair_batches
    from text_similarity_tpu_torch.models import encoder_forward
    from text_similarity_tpu_torch.train.steps import batch_to, trainable, value_and_grad

    dev = torch.device("cuda")
    params, arch = long_arch_params(torch, layers=2)
    leaves = trainable({"encoder": params}, dev)
    w = torch.randn(TRAIN_BUCKET, arch.hidden_size,
                    generator=torch.Generator(device=dev).manual_seed(9), device=dev)

    def projection_loss(p, batch, impl, precision):
        total = 0.0
        for side in ("a", "b"):
            mask = batch[f"mask_{side}"]
            h = encoder_forward(p["encoder"], batch[f"ids_{side}"], mask, arch=arch,
                                precision=precision, attention_impl=impl).last_hidden_state
            total = total + (h.float() * w * mask[..., None]).sum()
        return total, {}

    def grads(pair, impl, precision):
        batch = build_pair_batches(tok, [pair], np.zeros(1, np.float32), batch_size=1,
                                   max_len=TRAIN_BUCKET, shuffle=False)[0]
        if batch["ids_a"].shape[1] != TRAIN_BUCKET:
            raise AssertionError(f"the pair is not at bucket {TRAIN_BUCKET}")
        loss, _, g = value_and_grad(projection_loss, leaves, batch_to(batch, dev), impl, precision)
        return float(loss.detach()), {k: v.float() for k, v in flat_leaves(g).items()}

    rel = grad_rel
    readings = {}
    for name, precision, limit in (("f32", FP32_PRECISION, GRAD_F32),
                                   ("bf16", DEFAULT_PRECISION, GRAD_BF16)):
        la, ga = grads(pairs[0], "auto", precision)
        lr, gr = grads(pairs[0], "reference", precision)
        per_leaf, whole, floored = rel(ga, gr)
        worst_leaf = max(per_leaf, key=per_leaf.get)
        log(f"gradient agreement {name} [{card}]: loss auto {la:.6f} reference {lr:.6f}; per leaf "
            f"‖Δg‖/‖g‖ max {per_leaf[worst_leaf]:.3e} ({worst_leaf}), median "
            f"{float(np.median(list(per_leaf.values()))):.3e}, all leaves {whole:.3e} (limit "
            f"{limit}); against 1e-3 of the whole norm: {floored}")
        readings[name] = (per_leaf[worst_leaf], limit)
        if name == "bf16":
            _, go = grads(pairs[1], "auto", precision)
            ctrl_leaf, ctrl, _ = rel(go, gr)
            log(f"gradient control (another pair against the reference's): all leaves "
                f"{ctrl:.3e}, per leaf min {min(ctrl_leaf.values()):.3e} (the whole must be >= "
                f"{10 * GRAD_BF16:.2e})")
            readings["control"] = ctrl
    for name in ("f32", "bf16"):
        worst, limit = readings[name]
        if worst > limit:
            raise AssertionError(f"{name}: K5/K6 gradients differ from the reference path's by "
                                 f"{worst:.3e} > {limit}")
    if readings["control"] < 10 * GRAD_BF16:
        raise AssertionError(f"another pair's gradient differs by only {readings['control']:.3e}; "
                             f"the agreement gate could not tell pairs apart")


def phase_short_training(torch, card, ctx):
    """minilm-l6 (phase 4's weights) with the CLI's defaults: cosine MSE on
    64 synthetic pairs (batches of 32 at max_len 128, the reference
    attention), 30 steps on one repeated batch at lr 1e-4 through the
    Trainer (best and final checkpoints in a temporary directory); then the
    trained encoder is saved, loaded back and searched by K2."""
    from text_similarity_tpu_torch.core.config import TrainConfig
    from text_similarity_tpu_torch.data.pairs import build_pair_batches
    from text_similarity_tpu_torch.index import BruteForceIndex, EmbeddingStore
    from text_similarity_tpu_torch.models import SentenceEncoder
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda
    from text_similarity_tpu_torch.train import (
        Trainer, init_train_state, make_bi_encoder_train_step, make_optimizer,
    )

    import tempfile

    tok, corpus = ctx["tok"], ctx["corpus"]
    rng = np.random.default_rng(8)
    picks = rng.choice(len(corpus), 128, replace=False)
    pairs = [(corpus[i], corpus[j]) for i, j in zip(picks[:64], picks[64:])]
    scores = rng.random(64).astype(np.float32)
    batch = build_pair_batches(tok, pairs, scores, batch_size=32, max_len=128)[0]
    enc = SentenceEncoder(ctx["params"], ctx["enc"].arch, tokenizer=tok, device="cuda")
    steps = 30
    tx = make_optimizer(TrainConfig(lr=1e-4), steps, params_example={"encoder": enc.params})
    state = init_train_state({"encoder": enc.params}, tx, device="cuda")
    step = make_bi_encoder_train_step(enc.arch, tx, loss_type="cosine_mse", pooling=enc.pooling)
    losses = []

    def watched(st, b):
        st, metrics = step(st, b)
        losses.append(metrics["loss"])
        return st, metrics

    docs = [p[0] for p in pairs]
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t = time.time()
        trainer = Trainer(watched, state, save_path=os.path.join(tmp, "run"), log_every=10,
                          device="cuda")
        result = trainer.execute(lambda e: iter([batch] * steps), epochs=1)
        torch.cuda.synchronize()
        dt = time.time() - t
        saved = sorted(os.listdir(os.path.join(tmp, "run")))
        enc.params = result["state"].params["encoder"]
        enc.save(os.path.join(tmp, "model"))
        loaded = SentenceEncoder.load(os.path.join(tmp, "model"), device="cuda")
        e_enc = enc.encode(docs, device_output=True)
        e_load = loaded.encode(docs, device_output=True)
    losses = [float(x) for x in losses]
    store = EmbeddingStore(len(docs), enc.embedding_dim, device="cuda")
    store.add(e_enc)
    cosine_topk_cuda.launches = 0
    top_s, top_i = BruteForceIndex(store).query(e_load, k=5)
    first = int(sum(top_i[r, 0] == r for r in range(len(docs))))
    k2 = cosine_topk_cuda.launches
    same = float((e_enc - e_load).abs().max())
    log(f"short training [{card}]: minilm-l6, 32 pairs x {steps} steps in {dt:.2f} s (Trainer "
        f"with prefetch and async best/final checkpoints: {saved}); loss first {losses[0]:.5f}, "
        f"last {losses[-1]:.5f}, min {min(losses):.5f}; saved -> loaded encoder max|Δ| of 64 "
        f"embeddings {same:.2e}; K2 ({k2} launches) finds {first}/64 saved documents first")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the short-path loss did not fall: {losses[0]} -> {losses[-1]}")
    if same > 1e-6 or first != len(docs) or k2 == 0:
        raise AssertionError("the trained encoder did not survive save -> load -> search")


# ---------------------------------------------------------------------------
# Phase 8: head-packed attention (K7)
# ---------------------------------------------------------------------------

PACKED_BUCKETS = (32, 64, 128)
# bf16 last_hidden_state of minilm-l6, the K7 path against the reference
# path, valid rows: about 2.5x the first readings on an H100 (mean 3.13e-3,
# max 0.094), where another row's states differ by a mean of 0.61
PACKED_AGREE_MEAN, PACKED_AGREE_MAX = 8e-3, 0.25


def phase_packed_attention(torch, card):
    """K7 against its plain version on every row (B 64 × S 128 × H 12, D 32
    and 64, ragged lengths with a full and a zero-length row, f32 and bf16;
    q, k, v as views of a fused QKV), then its time at B 128 × S 128 × H 12
    × D 32 bf16 beside the plain version and SDPA with a boolean key mask.
    → K7's row."""
    import torch.nn.functional as F

    from text_similarity_tpu_torch.ops.attention import (
        packed_attention_cuda, packed_attention_path, packed_attention_plain,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    lengths = torch.randint(1, 129, (64,), generator=g, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = 128, 0
    worst = 0.0
    for d in (32, 64):
        qkv = torch.randn(64, 128, 12, 3, d, generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = qkv.to(dtype)
            q, k, v = x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]
            out = packed_attention_cuda(q, k, v, lengths)
            ref = packed_attention_plain(q, k, v, lengths)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            err, mean = float(diff.max()), float(diff.mean())
            zero_ok = bool((out[lengths == 0] == 0).all())
            worst = max(worst, err)
            ok = (err <= 1e-4 if dtype == torch.float32 else err <= 1e-2 and mean <= 5e-4) and zero_ok
            log(f"K7 {str(dtype)[6:]} B=64 S=128 H=12 D={d} (every row, padded ones too): max|Δ| "
                f"{err:.2e}, mean|Δ| {mean:.2e}, zero-length row exact {zero_ok} -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("K7 disagrees with its plain version")

    b, s, h, d = 128, 128, 12, 32
    x = torch.randn(b, s, h, 3, d, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]
    lengths = torch.randint(16, s + 1, (b,), generator=g, device=dev, dtype=torch.int32)
    key_ok = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    path = packed_attention_path(s, q.dtype)
    if path != "one sweep":
        raise AssertionError(f"bf16 K7 at S {s} runs {path}, not the one-sweep kernel")
    # the kernel and SDPA as the host calls them: the median of three
    # alternating rounds of 100 calls; a call takes about the host's cost
    # of making it (about 0.05 ms), so both are also timed on the device,
    # 100 calls in a CUDA graph
    rounds = [(time_ms(torch, lambda: packed_attention_cuda(q, k, v, lengths), 100, 10),
               time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=key_ok),
                       100, 10))
              for _ in range(3)]
    ms, lib = (float(np.median(r)) for r in zip(*rounds))
    dev_ms = graph_ms(torch, lambda: packed_attention_cuda(q, k, v, lengths))
    lib_dev_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=key_ok))
    plain = time_ms(torch, lambda: packed_attention_plain(q, k, v, lengths), iters=3, warmup=1)
    sdpa_err = float((F.scaled_dot_product_attention(qt, kt, vt, attn_mask=key_ok).transpose(1, 2)
                      .float() - packed_attention_cuda(q, k, v, lengths).float()).abs().max())
    # q read and o written in full (padded query rows are computed), K and V
    # only for the valid keys j < len, and the lengths
    n_valid = float(lengths.sum())
    n_bytes = 2 * b * s * h * d * 2 + 2 * n_valid * h * d * 2 + b * 4
    ops = 4.0 * d * h * s * n_valid                 # every query row against its valid keys
    b_ms, b_by = bound_ms(n_bytes, ops, PEAK_BF16)
    log(f"K7 times [{card}]: bf16 B={b} S={s} H={h} D={d} (lengths 16-128), "
        f"{path}: kernel {ms:.4f} ms a call, plain {plain:.3f} ms, SDPA "
        f"(bool key mask) {lib:.4f} ms a call (max|Δ| vs kernel {sdpa_err:.2e}), bound "
        f"{b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP); rounds "
        f"(kernel, SDPA): {', '.join(f'({x:.4f}, {y:.4f})' for x, y in rounds)}; on the device "
        f"(CUDA graph): kernel {dev_ms:.4f} ms, SDPA {lib_dev_ms:.4f} ms")
    return {
        "name": "packed_attention", "route": "cuda",
        "source": "text_similarity_tpu_torch/csrc/packed_attention.cu",
        "replaces": "text_similarity_tpu/ops/attention.py:684",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "shape": f"B={b} S={s} H={h} D={d} bf16, lengths 16-128",
        "path": path, "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
    }


def phase_packed_encode(torch, card, ctx):
    """minilm-l6 (phase 4's bf16 weights) runs ``encoder_forward`` with
    ``attention_impl="packed"`` over phase 4's sentences and joins of three
    of them, in length-bucketed batches of 128 at 32 / 64 / 128, with K7's
    counter zeroed just before; the same batches through the reference
    attention; last_hidden_state on valid rows and the pooled embeddings
    compared. → K7's launches in that encode."""
    import torch.nn.functional as F

    from text_similarity_tpu_torch.data import LengthBucketBatcher
    from text_similarity_tpu_torch.models import encoder_forward, mean_pool
    from text_similarity_tpu_torch.ops.attention import packed_attention_cuda, packed_attention_path

    enc, corpus = ctx["enc"], ctx["corpus"]
    texts = corpus[:1792] + [" ".join(corpus[j:j + 3]) for j in range(2000, 2768, 3)]
    rows = enc._tokenize_rows(texts, 128)
    batcher = LengthBucketBatcher(128, buckets=PACKED_BUCKETS, shuffle_batches=False)
    batches = []
    for batch in batcher.batches(rows, pad_id=enc.tokenizer.pad_id):
        sel = batch["valid"]
        batches.append((torch.from_numpy(batch["ids"][sel]).cuda(),
                        torch.from_numpy(batch["mask"][sel]).cuda()))
    widths = sorted({int(ids.shape[1]) for ids, _ in batches})

    def forward(impl):
        with torch.no_grad():
            params = enc.params
            return [encoder_forward(params, ids, mask, arch=enc.arch, precision=enc.precision,
                                    attention_impl=impl).last_hidden_state
                    for ids, mask in batches]

    forward("packed")                     # warm the path outside the counted window
    packed_attention_cuda.launches = packed_attention_cuda.launches_one_sweep = 0
    torch.cuda.synchronize()
    t = time.time()
    packed = forward("packed")
    torch.cuda.synchronize()
    packed_s = time.time() - t
    launches, one_sweep = packed_attention_cuda.launches, packed_attention_cuda.launches_one_sweep
    t = time.time()
    ref = forward("reference")
    torch.cuda.synchronize()
    ref_s = time.time() - t

    diffs, control, cos = [], [], []
    for (_, mask), a, r in zip(batches, packed, ref):
        valid = mask.bool()
        diffs.append((a.float() - r.float()).abs()[valid])
        both = valid & valid.roll(1, 0)
        control.append((a.float() - r.float().roll(1, 0)).abs()[both])
        ea, er = (F.normalize(mean_pool(x, mask).float(), dim=-1) for x in (a, r))
        cos.append((ea * er).sum(dim=1))
    diff, control, cos = torch.cat(diffs), float(torch.cat(control).mean()), float(torch.cat(cos).min())
    mean, worst = float(diff.mean()), float(diff.max())
    log(f"minilm-l6 packed attention [{card}]: {len(texts)} texts in {len(batches)} batches at "
        f"widths {widths}: K7 path {packed_s * 1e3:.1f} ms, reference path {ref_s * 1e3:.1f} ms "
        f"(encoder_forward, host clock); K7 launches {launches} (6 layers x {len(batches)} "
        f"batches), {one_sweep} of them on the one-sweep kernel (the kernel library's choice: "
        f"{', '.join(f'S {w}: {packed_attention_path(w, torch.bfloat16)}' for w in widths)}); "
        f"last_hidden_state on valid rows mean|Δ| {mean:.3e}, max|Δ| {worst:.3e} "
        f"(another row's: mean|Δ| {control:.3e}); pooled min cosine {cos:.6f}")
    split = profile_split(torch, "one minilm-l6 packed-attention pass over those batches",
                          lambda: forward("packed"), card,
                          groups=(("K7 packed_attn", ("packed_attn",)),
                                  ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass"))))
    if split is not None:
        k7 = {key: n for key, n in split["kernels"].items() if "packed_attn" in key}
        log(f"K7's share of the minilm-l6 packed-attention pass: {split['K7 packed_attn']:.3f} ms "
            f"of {split['busy']:.3f} ms device time "
            f"({split['K7 packed_attn'] / split['busy']:.1%}), wall {split['wall']:.2f} ms; "
            f"its kernels as the profiler names them: "
            f"{'; '.join(f'{key} x{n}' for key, n in k7.items())} [{card}]")
    if launches != 6 * len(batches):
        raise AssertionError(f"K7 launched {launches} times, expected 6 x {len(batches)}")
    # bf16 at S ≤ 128 (every width here) takes the one-sweep kernel
    if one_sweep != launches:
        raise AssertionError(f"K7's one-sweep kernel launched {one_sweep} of {launches} times")
    if mean > PACKED_AGREE_MEAN or worst > PACKED_AGREE_MAX or cos < 0.99:
        raise AssertionError(f"the K7 path and the reference path disagree (mean|Δ| {mean:.3e}, "
                             f"max|Δ| {worst:.3e}, min cosine {cos:.6f})")
    if control < 10 * PACKED_AGREE_MEAN:
        raise AssertionError(f"another row's states differ by only {control:.3e}; the agreement "
                             f"gate could not tell rows apart")
    return launches


# ---------------------------------------------------------------------------
# Phase 9: serving
# ---------------------------------------------------------------------------

# /rerank's scores (packed: the auto route at 100 pairs, the wave path at
# 3,200) against the cross-encoder's bucketed predict of the same pairs,
# bf16 on the card: 2.5x the first reading on an H100 (max|Δ| 6.2e-2 at 100
# pairs, 1.058e-1 at 3,200, where the scores' std is 0.11 and 0.32: the
# bucketed route rounds the pooler's output to bf16, the packed one keeps
# it in f32); and the mean |Δ| at most a quarter of the control's, the
# same scores against a random permutation of the pairs (on an H100: mean
# 1.15e-2 against the control's 1.09e-1 at 100 pairs, 1.21e-2 against
# 3.68e-1 at 3,200)
RERANK_AGREE_MAX = 0.27
# a micro-batched /search answer against the unbatched one: the query's
# embedding may take the packed route in a batch and the bucketed one alone,
# and 1 − cos ≤ PACK_AGREE_COS bounds each score's change by √(2·that)
BATCH_SCORE_TOL = (2 * PACK_AGREE_COS) ** 0.5


def http_call(port, path, payload=None, timeout=120):
    """One JSON request to the daemon on 127.0.0.1 → (status, body, ms)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    t = time.time()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), (time.time() - t) * 1e3
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), (time.time() - t) * 1e3


def http_ok(port, path, payload=None):
    code, body, ms = http_call(port, path, payload)
    if code != 200:
        raise AssertionError(f"{path}: HTTP {code}: {body}")
    return body, ms


def tokenizer_records(torch, card, corpus, tok):
    """The 120k corpus through the native and the Python tokenizer (equal
    ids, both host times), and pack_sequences with the native and the
    Python FFD (equal layouts, both host times)."""
    from text_similarity_tpu_torch.data import BUCKETS, packing, pick_bucket
    from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer

    py = WordPieceTokenizer(tok.vocab, lowercase=tok.lowercase, use_native=False)
    rec, out = {}, {}
    for label, fn in (("tokenize_many", lambda t: t.tokenize_many(corpus)),
                      ("encode_batch", lambda t: t.encode_batch(corpus, max_len=256))):
        t = time.time()
        out[label] = fn(tok)
        rec[label + " native"] = (time.time() - t) * 1e3
        t = time.time()
        want = fn(py)
        rec[label + " python"] = (time.time() - t) * 1e3
        got = out[label]
        same = got == want if label == "tokenize_many" else all(
            np.array_equal(g, w) for g, w in zip(got, want))
        if not same:
            raise AssertionError(f"native and Python {label} disagree on the corpus")
    rows = [[tok.cls_id] + r[:254] + [tok.sep_id] for r in out["tokenize_many"]]
    width = pick_bucket(max(len(r) for r in rows), BUCKETS)
    lens = np.sort(np.asarray([len(r) for r in rows], np.int32))[::-1]
    placed = {}
    for label, place in (("native", packing.ffd_place_native), ("python", packing._ffd_place_py)):
        t = time.time()
        placed[label] = place(lens, width)
        rec["FFD placement " + label] = (time.time() - t) * 1e3
    a, b = placed["native"], placed["python"]
    if a[0] != b[0] or any(not np.array_equal(x, y) for x, y in zip(a[1:], b[1:])):
        raise AssertionError("the native and the Python FFD place differently")
    t = time.time()
    native = packing.pack_sequences(rows, width, pad_id=tok.pad_id)
    rec["pack_sequences native"] = (time.time() - t) * 1e3
    saved, packing.NATIVE_MIN = packing.NATIVE_MIN, len(rows) + 1   # the Python FFD
    try:
        t = time.time()
        python = packing.pack_sequences(rows, width, pad_id=tok.pad_id)
        rec["pack_sequences python"] = (time.time() - t) * 1e3
    finally:
        packing.NATIVE_MIN = saved
    if set(native) != set(python) or any(not np.array_equal(native[k], python[k]) for k in native):
        raise AssertionError("pack_sequences: the native and the Python FFD place differently")
    log(f"host tokenize + FFD of {len(corpus)} documents: "
        + "; ".join(f"{k} {v:.1f} ms" for k, v in rec.items())
        + f" (ids and layouts equal; {native['ids'].shape[0]} rows of {width}) [{card}]")
    return rec


def search_gate(torch, pipe, port, label, sizes, rng, card):
    """/search requests of verbatim corpus sentences through the daemon:
    ≥ 95% find themselves in the top 10 at score ≥ 0.99 (on a multi-query
    IVF request, of the queries whose own slab was probed, as phase 4)."""
    picks = rng.choice(len(pipe.corpus), size=sum(sizes), replace=False)
    start = 0
    for size in sizes:
        req = picks[start:start + size]
        start += size
        texts = [pipe.corpus[j] for j in req]
        body, ms = http_ok(port, "/search", {"queries": texts, "k": 10})
        hits = [any(x["id"] == j and x["score"] >= 0.99 for x in row)
                for j, row in zip(req, body["results"])]
        counted = (own_slab_probed(torch, pipe, texts, req) if pipe.ivf is not None and size > 1
                   else [True] * size)
        n = sum(counted)
        found = sum(h for h, c in zip(hits, counted) if c)
        log(f"{label}: /search of {size}: {found}/{n} counted queries find themselves "
            f"({sum(hits)}/{size} in all), {ms:.1f} ms [{card}]")
        if n == 0 or found < 0.95 * n:
            raise AssertionError(f"{label}: /search of {size}: self-retrieval {found}/{n}")


def concurrent_clients(port, texts, k=10):
    """One thread a text, each a single-query /search → (results, seconds)."""
    import threading

    out, errors = {}, []

    def one(i):
        try:
            out[i] = http_ok(port, "/search", {"queries": [texts[i]], "k": k})[0]["results"][0]
        except Exception as e:  # recorded, raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(texts))]
    t = time.time()
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    dt = time.time() - t
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"concurrent clients failed: {errors[:3]}")
    return [out[i] for i in range(len(texts))], dt


def rerank_check(torch, card, port, lock, rr, queries, label):
    """/rerank of ``queries`` with k = retrieve_k: every row is a subset of
    that query's retrieved candidates (the same retrieval call), sorted
    best first, and its scores equal the cross-encoder's bucketed predict
    of the same pairs within RERANK_AGREE_MAX. → (ms, max|Δ|)."""
    ce = rr.cross_encoder
    body, ms = http_ok(port, "/rerank", {"queries": queries, "k": rr.retrieve_k})
    with lock, torch.no_grad():     # the daemon is idle: the same retrieval
        retrieved = rr.search(queries, max_num_results=rr.retrieve_k)
    pairs, got = [], []
    for q, row, cands in zip(queries, body["results"], retrieved):
        ids = [x["id"] for x in row]
        scores = [x["score"] for x in row]
        if not set(ids) <= {cid for _, _, cid in cands} or len(ids) != len(cands):
            raise AssertionError(f"{label}: /rerank returned ids outside the retrieved set")
        if scores != sorted(scores, reverse=True):
            raise AssertionError(f"{label}: /rerank row not sorted best first")
        pairs += [(q, x["document"]) for x in row]
        got += scores
    want = ce.predict(pairs, packed=False)
    got = np.asarray(got, np.float32)
    err = float(np.abs(got - want).max())
    mean = float(np.abs(got - want).mean())
    control = float(np.abs(got - want[np.random.default_rng(0).permutation(len(want))]).mean())
    log(f"{label}: /rerank of {len(queries)} quer{'y' if len(queries) == 1 else 'ies'} "
        f"({len(pairs)} pairs) {ms:.1f} ms; scores against the bucketed predict: max|Δ| "
        f"{err:.3e} (limit {RERANK_AGREE_MAX:.2f}), mean|Δ| {mean:.3e}; control, a "
        f"permutation of the pairs: mean|Δ| {control:.3e}; spread across pairs: std "
        f"{float(want.std()):.3e}, range {float(np.ptp(want)):.3e} [{card}]")
    if err > RERANK_AGREE_MAX or mean > 0.25 * control:
        raise AssertionError(f"{label}: /rerank scores differ from predict (max|Δ| {err:.3e}, "
                             f"mean|Δ| {mean:.3e} against the control's {control:.3e})")
    return ms, err


def serve_subprocess(card, enc_dir, pipe_dir, ce_dir, corpus):
    """``python -m text_similarity_tpu_torch serve --model ENC --load PIPE
    --rerank-model CE --int8 --port 0``: at most 120 s to "warmed rerank
    path" and "serving on …", then /health, one /search and one /rerank,
    then SIGINT; its exit code must be 0 and its stderr hold no traceback
    and no error line."""
    import queue
    import signal
    import threading

    cmd = [sys.executable, "-m", "text_similarity_tpu_torch", "serve", "--model", enc_dir,
           "--load", pipe_dir, "--rerank-model", ce_dir, "--int8", "--port", "0"]
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    err_lines = []

    def read_stdout():
        for line in proc.stdout:
            lines.put(line)

    threading.Thread(target=read_stdout, daemon=True).start()
    err_reader = threading.Thread(target=lambda: err_lines.extend(proc.stderr), daemon=True)
    err_reader.start()
    try:
        warmed = port = None
        while port is None:
            left = 120 - (time.time() - t0)
            if left <= 0 or proc.poll() is not None:
                raise AssertionError(f"serve did not start within 120 s (rc {proc.poll()}): "
                                     f"{''.join(err_lines)[-2000:]}")
            try:
                line = lines.get(timeout=min(left, 1.0))
            except queue.Empty:
                continue
            if line.startswith("warmed rerank path"):
                warmed = time.time() - t0
            elif line.startswith("serving on http://"):
                port = int(line.strip().rsplit(":", 1)[1])
        if warmed is None:
            raise AssertionError("serve printed no 'warmed rerank path' before serving")
        ready = time.time() - t0
        health, _ = http_ok(port, "/health")
        res, s_ms = http_ok(port, "/search", {"queries": [corpus[7]], "k": 10})
        rr, r_ms = http_ok(port, "/rerank", {"queries": [corpus[7]], "k": 10})
        for name, body in (("/search", res), ("/rerank", rr)):
            row = body["results"][0]
            scores = [x["score"] for x in row]
            if len(row) != 10 or not np.all(np.isfinite(scores)) or scores != sorted(
                    scores, reverse=True):
                raise AssertionError(f"serve subprocess: bad {name} answer {row[:2]}")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
        err_reader.join(10)
        stderr = "".join(err_lines)
        log(f"serve subprocess (--int8): warmed rerank path at {warmed:.1f} s, serving at "
            f"{ready:.1f} s; /health {health}; /search {s_ms:.1f} ms, /rerank {r_ms:.1f} ms; "
            f"exit {rc} on SIGINT [{card}]")
        if rc != 0 or "Traceback" in stderr or " ERROR " in stderr:
            raise AssertionError(f"serve subprocess exit {rc}, stderr: {stderr[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def phase_serving(torch, card, ctx):
    import tempfile

    from text_similarity_tpu_torch.core.config import ARCH_PRESETS
    from text_similarity_tpu_torch.data import pack_pair_arrays
    from text_similarity_tpu_torch.index.ivf import ivf_scan_cuda
    from text_similarity_tpu_torch.models.cross_encoder import CrossEncoder
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda
    from text_similarity_tpu_torch.pipelines import RankingPipeline, SearchServer

    corpus, tok, big, small = ctx["corpus"], ctx["tok"], ctx["big"], ctx["small"]
    if tok._native is None:
        raise AssertionError("the phase-4 tokenizer does not run the native matcher")
    tokenizer_records(torch, card, corpus, tok)

    # the cross-encoder: minilm-l6 (token types, pooler) at full width,
    # random weights from a seed, one output; a head of std 1 (not 0.02)
    # spreads the scores across pairs far beyond bf16 noise
    ce = CrossEncoder.init(torch.Generator().manual_seed(7), ARCH_PRESETS["minilm-l6"],
                           tokenizer=tok, num_classes=1, device="cuda")
    ce.params["head"]["w"].mul_(50.0)
    if ce.device.type != "cuda" or any(
            not t.is_cuda for t in flat_leaves(ce.params).values()):
        raise AssertionError("the cross-encoder is not on the card")
    rr = RankingPipeline(big, ce, retrieve_k=100)
    ctx["ce"] = ce
    packed_calls, wave_calls = [], []
    real_layout, real_wave = ce._predict_packed_layout, rr._predict_pipelined
    ce._predict_packed_layout = lambda *a, **k: packed_calls.append(1) or real_layout(*a, **k)
    rr._predict_pipelined = lambda p, **k: wave_calls.append(len(p)) or real_wave(p, **k)

    # queueing a packed layout must not wait for the device: that is what
    # lets the wave path overlap host and card
    pairs = [(corpus[i], corpus[i + 1]) for i in range(256)]
    ba, la = tok.encode_bodies([p[0] for p in pairs], 253)
    bb, lb = tok.encode_bodies([p[1] for p in pairs], 253)
    layout = pack_pair_arrays(ba, la, bb, lb, 256, cls_id=tok.cls_id, sep_id=tok.sep_id,
                              pad_id=tok.pad_id)
    ce._dispatch_packed_layout(layout)   # warm: the pinned pool, cuBLAS
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = ce._dispatch_packed_layout(layout)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out = np.zeros(len(pairs), np.float32)
    ce._collect_packed(pending, out)
    log("CrossEncoder._dispatch_packed_layout queued 256 pairs with no host-device "
        "synchronisation (torch.cuda.set_sync_debug_mode('error'))")

    rng = np.random.default_rng(9)
    servers = {
        f"ivf server ({len(big.corpus)} docs)": SearchServer(big, port=0, batch_window=0.002,
                                                             reranker=rr),
        f"brute server ({len(small.corpus)} docs)": SearchServer(small, port=0,
                                                                 batch_window=0.002),
    }
    for srv in servers.values():
        srv.start_background()
    try:
        (ivf_label, ivf_srv), (brute_label, brute_srv) = servers.items()
        cosine_topk_cuda.launches = 0
        ivf_scan_cuda.launches = ivf_scan_cuda.launches_tile = 0
        search_gate(torch, big, ivf_srv.port, ivf_label, [1, 5, 64], rng, card)
        k1 = (ivf_scan_cuda.launches, ivf_scan_cuda.launches_tile)
        search_gate(torch, small, brute_srv.port, brute_label, [1, 5, 64], rng, card)
        k2 = cosine_topk_cuda.launches
        log(f"launches during /search: K1 {k1[0]} ({k1[1]} on the wgmma tile), K2 {k2}")
        if k1[0] == 0 or k1[0] != k1[1] or k2 == 0:
            raise AssertionError(f"/search did not run K1 on the tile and K2: K1 {k1}, K2 {k2}")

        # 32 concurrent single-query clients, micro-batched. On the brute
        # server each answer must equal the unbatched one (ids where the
        # scores are separated, scores within BATCH_SCORE_TOL). On the
        # IVF server a batched query shares its block's probe union with
        # its companions (phase 4), which need not hold its own slab: there
        # every answer must hold 10 finite scores, best first, and the
        # share that finds itself first is a record.
        for label, srv, pipe in ((brute_label, brute_srv, small), (ivf_label, ivf_srv, big)):
            picks = rng.choice(len(pipe.corpus), 32, replace=False)
            texts = [pipe.corpus[j] for j in picks]
            with srv.lock, torch.no_grad():
                want = [pipe([t], max_num_results=10)[0] for t in texts]
            got, dt = concurrent_clients(srv.port, texts)
            top_self = sum(row[0]["id"] == j for row, j in zip(got, picks))
            log(f"{label}: 32 concurrent single-query clients in {dt * 1e3:.1f} ms = "
                f"{32 / dt:.1f} QPS (micro-batched, window 2 ms); {top_self}/32 find "
                f"themselves first [{card}]")
            for row in got:
                scores = [x["score"] for x in row]
                if len(row) != 10 or not np.all(np.isfinite(scores)) or scores != sorted(
                        scores, reverse=True):
                    raise AssertionError(f"{label}: a bad concurrent answer: {row[:2]}")
            if pipe is small:
                if top_self < 0.95 * 32:
                    raise AssertionError(f"{label}: {top_self}/32 clients find themselves first")
                for row, ref in zip(got, want):
                    gs = np.asarray([[x["score"] for x in row]])
                    rs = np.asarray([[s for _, s, _ in ref]])
                    if (float(np.abs(gs - rs).max()) > BATCH_SCORE_TOL or not separated_ids_equal(
                            np.asarray([[x["id"] for x in row]]),
                            np.asarray([[i for _, _, i in ref]]), rs, tol=2 * BATCH_SCORE_TOL)):
                        raise AssertionError(f"{label}: a micro-batched answer differs from "
                                             f"the unbatched one: {row[:3]} vs {ref[:3]}")

        # an empty request is a 400, and the daemon (its batcher) lives on
        code, body, _ = http_call(ivf_srv.port, "/search", {"queries": [], "k": 10})
        if code != 400:
            raise AssertionError(f"empty /search answered {code}: {body}")
        http_ok(ivf_srv.port, "/search", {"queries": [corpus[3]], "k": 10})

        # /rerank: 1 query (100 pairs, the packed auto route), 32 queries
        # (3,200 pairs, the wave path); K1 retrieves both
        ivf_scan_cuda.launches = ivf_scan_cuda.launches_tile = 0
        q32 = [corpus[j] for j in rng.choice(len(corpus), 32, replace=False)]
        ms1, _ = rerank_check(torch, card, ivf_srv.port, ivf_srv.lock, rr, [corpus[11]],
                              ivf_label)
        if not packed_calls or wave_calls:
            raise AssertionError(f"/rerank of 100 pairs did not take the packed route "
                                 f"({len(packed_calls)} packed, waves {wave_calls})")
        ms32, _ = rerank_check(torch, card, ivf_srv.port, ivf_srv.lock, rr, q32, ivf_label)
        if wave_calls != [3200]:
            raise AssertionError(f"/rerank of 3,200 pairs did not take the wave path: "
                                 f"{wave_calls}")
        if ivf_scan_cuda.launches == 0 or ivf_scan_cuda.launches != ivf_scan_cuda.launches_tile:
            raise AssertionError("the /rerank retrievals did not run K1 on the wgmma tile")

        # steady state, one request at a time: the daemon's latency beside
        # the same call made directly (its HTTP and batching cost), and
        # where a one-query /rerank spends its time
        one = [corpus[j] for j in rng.choice(len(corpus), 20, replace=False)]
        for label, srv, pipe in ((ivf_label, ivf_srv, big), (brute_label, brute_srv, small)):
            via = [http_ok(srv.port, "/search", {"queries": [one[i]], "k": 10})[1]
                   for i in range(20)]
            with srv.lock, torch.no_grad():
                direct = [host_ms(torch, lambda: pipe([one[i]], 10), reps=1) for i in range(20)]
            log(f"{label}: 20 one-text /search requests one at a time: median "
                f"{np.median(via):.2f} ms (min {min(via):.2f}), the pipeline called directly "
                f"{np.median(direct):.2f} ms (min {min(direct):.2f}) [{card}]")
        via = [http_ok(ivf_srv.port, "/rerank", {"queries": [one[i]], "k": 10})[1]
               for i in range(5)]
        with ivf_srv.lock, torch.no_grad():
            cands = big([one[0]], max_num_results=100)[0]
            pairs1 = [(one[0], d) for d, _, _ in cands]
            split = {"the whole rerank": host_ms(torch, lambda: rr([one[0]], top_k=10)),
                     "retrieve 100": host_ms(torch, lambda: big([one[0]], max_num_results=100)),
                     "predict 100 pairs": host_ms(torch, lambda: ce.predict(pairs1)),
                     "tokenize both sides": host_ms(torch, lambda: (
                         tok.encode_bodies([p[0] for p in pairs1], 253),
                         tok.encode_bodies([p[1] for p in pairs1], 253)))}
        log(f"{ivf_label}: 5 one-query /rerank requests one at a time: median "
            f"{np.median(via):.2f} ms; called directly: "
            + "; ".join(f"{k} {v:.2f} ms" for k, v in split.items()) + f" [{card}]")

        # /encode, /add and /remove of 100 documents
        new_docs = [" ".join(reversed(d.split())) for d in corpus[:100]]
        emb = np.asarray(http_ok(ivf_srv.port, "/encode", {"texts": new_docs})[0]["embeddings"])
        if emb.shape != (100, 384) or not np.all(np.isfinite(emb)) or float(
                np.abs(np.linalg.norm(emb, axis=1) - 1).max()) > 1e-3:
            raise AssertionError(f"/encode: bad embeddings {emb.shape}")
        n0 = len(big.corpus)
        ids = http_ok(ivf_srv.port, "/add", {"texts": new_docs})[0]["ids"]
        row = http_ok(ivf_srv.port, "/search", {"queries": [new_docs[5]], "k": 10})[0]
        found = [x for x in row["results"][0] if x["id"] == ids[5] and x["score"] >= 0.99]
        if ids != list(range(n0, n0 + 100)) or not found:
            raise AssertionError(f"/add: the added document does not find itself: "
                                 f"{row['results'][0][:2]}")
        if http_ok(ivf_srv.port, "/remove", {"ids": ids})[0]["removed"] != 100:
            raise AssertionError("/remove did not remove the 100 documents")
        row = http_ok(ivf_srv.port, "/search", {"queries": [new_docs[5]], "k": 10})[0]
        if any(x["id"] in set(ids) for x in row["results"][0]):
            raise AssertionError("a removed document came back")
        log(f"{ivf_label}: /health {http_ok(ivf_srv.port, '/health')[0]}")
        for label, srv, errors in ((ivf_label, ivf_srv, 1), (brute_label, brute_srv, 0)):
            metrics = http_ok(srv.port, "/metrics")[0]
            for path, m in sorted(metrics.items()):
                log(f"{label} {path}: {m['requests']} requests, {m['errors']} errors, p50 "
                    f"{m['latency_ms_p50']} ms, p95 {m['latency_ms_p95']} ms [{card}]")
            # the one error: the empty /search
            if sum(m["errors"] for m in metrics.values()) != errors:
                raise AssertionError(f"{label}: unexpected server errors: {metrics}")
        log(f"/rerank latency: 1 query {ms1:.1f} ms, 32 queries {ms32:.1f} ms [{card}]")
    finally:
        for srv in servers.values():
            srv.shutdown()

    # the entry point itself, on this phase's saved directories
    build = os.path.join(REPO, "text_similarity_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        t = time.time()
        ctx["enc"].save(os.path.join(tmp, "enc"))
        big.save(os.path.join(tmp, "pipe"))
        ce.save(os.path.join(tmp, "ce"))
        log(f"saved the encoder, the {len(big.corpus)}-document pipeline and the cross-encoder in "
            f"{time.time() - t:.1f} s")
        serve_subprocess(card, os.path.join(tmp, "enc"), os.path.join(tmp, "pipe"),
                         os.path.join(tmp, "ce"), corpus)


# ---------------------------------------------------------------------------
# Phase 10: training entry points (ALBERT, the CLI's train / eval commands,
# pretrain-long)
# ---------------------------------------------------------------------------

# ALBERT's bucketed and packed sentence encodes are gated by phase 4's
# PACK_AGREE_* limits; the shared layer's gradient against the sum of an
# unshared 12-layer copy's (f32, dropout 0), per leaf
ALBERT_GRAD_REL = 1e-5


def cli_lines(torch, argv):
    """The port's CLI in this process → (seconds, the lines it printed)."""
    import contextlib
    import io

    from text_similarity_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    torch.cuda.synchronize()
    t = time.time()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    torch.cuda.synchronize()
    return time.time() - t, buf.getvalue().strip().splitlines()


def cli(torch, argv, card):
    """The port's CLI in this process → (seconds, the JSON object it printed
    last), which is logged."""
    dt, lines = cli_lines(torch, argv)
    start = max(i for i, line in enumerate(lines) if line.startswith("{"))
    out = json.loads("\n".join(lines[start:]))
    log(f"  {argv[0]}: {dt:.1f} s -> {json.dumps(out)[:300]} [{card}]")
    return dt, out


def bench_length_rows(rng, words, n):
    """n sentences of bench.py's packed-train length law (log-normal(3.1,
    0.45) tokens, clipped to 6-126) made of corpus words, which the phase-4
    vocabulary holds whole (about one token a word)."""
    lens = np.clip(np.round(np.exp(rng.normal(3.1, 0.45, n))).astype(int), 6, 126)
    return [" ".join(words[j] for j in rng.integers(0, len(words), n_)) for n_ in lens]


def albert_records(torch, card, ctx):
    """albert-base (H 768, E 128, one shared layer run 12 times; random
    weights, seed 0) on phase 4's tokenizer: the packed="auto" and
    packed=False encodes of 2,000 sentences beside minilm-l6's, K7 over
    length-bucketed batches, and the shared leaf's gradient."""
    import torch.nn.functional as F

    from text_similarity_tpu_torch.core.config import ARCH_PRESETS
    from text_similarity_tpu_torch.core.precision import FP32_PRECISION
    from text_similarity_tpu_torch.data import BUCKETS, LengthBucketBatcher, build_pair_batches
    from text_similarity_tpu_torch.models import (
        SentenceEncoder, encoder_forward, init_params, mean_pool,
    )
    from text_similarity_tpu_torch.ops.attention import packed_attention_cuda
    from text_similarity_tpu_torch.train.steps import (
        batch_to, bi_encoder_loss, trainable, value_and_grad,
    )

    tok, corpus = ctx["tok"], ctx["corpus"]
    arch = ARCH_PRESETS["albert-base"].replace(vocab_size=tok.vocab_size)
    params = init_params(arch, torch.Generator().manual_seed(0))
    enc = SentenceEncoder(params, arch, tokenizer=tok, device="cuda")
    texts = corpus[4000:6000]
    rows = enc._tokenize_rows(texts, 256)
    if not enc.use_packed(rows, 128, BUCKETS):
        raise AssertionError("ALBERT's 2,000-sentence encode does not take the packed route")
    rates, embs = {}, {}
    for name, e, packed in (("albert auto (packed)", enc, "auto"),
                            ("albert packed=False", enc, False),
                            ("minilm-l6 auto (packed)", ctx["enc"], "auto")):
        e.encode(texts[:256], device_output=True, packed=packed)       # warm
        torch.cuda.synchronize()
        t = time.time()
        embs[name] = e.encode(texts, device_output=True, packed=packed)
        torch.cuda.synchronize()
        rates[name] = len(texts) / (time.time() - t)
    a, b = embs["albert auto (packed)"], embs["albert packed=False"]
    cos = (a * b).sum(dim=1)
    gap, worst = 1.0 - float(cos.min()), float((a - b).abs().max())
    ctl = 1.0 - float((b.roll(1, 0) * a).sum(dim=1).min())
    log(f"ALBERT albert-base encode of {len(texts)} sentences [{card}]: "
        + ", ".join(f"{k} {v:.0f} sentences/s" for k, v in rates.items())
        + f"; packed vs bucketed unit embeddings 1 − min cosine {gap:.2e}, max|Δ| {worst:.3e} "
        f"(limits {PACK_AGREE_COS:.1e}, {PACK_AGREE_MAX:.1e}); control 1 − min cosine {ctl:.2e}")
    if gap > PACK_AGREE_COS or worst > PACK_AGREE_MAX or ctl < 100 * PACK_AGREE_COS:
        raise AssertionError(f"ALBERT's packed and bucketed encodes disagree (1 − min cosine "
                             f"{gap:.2e}, max|Δ| {worst:.3e}) or the control does not separate")

    # K7 in each of the 12 iterations of the shared layer
    batcher = LengthBucketBatcher(128, buckets=PACKED_BUCKETS, shuffle_batches=False)
    batches = [(torch.from_numpy(bt["ids"][bt["valid"]]).cuda(),
                torch.from_numpy(bt["mask"][bt["valid"]]).cuda())
               for bt in batcher.batches(enc._tokenize_rows(texts, 128), pad_id=tok.pad_id)]
    p = enc.params
    with torch.no_grad():
        packed_attention_cuda.launches = 0
        got = [encoder_forward(p, ids, m, arch=arch, precision=enc.precision,
                               attention_impl="packed").last_hidden_state for ids, m in batches]
        torch.cuda.synchronize()
        k7 = packed_attention_cuda.launches
        ref = [encoder_forward(p, ids, m, arch=arch, precision=enc.precision,
                               attention_impl="reference").last_hidden_state
               for ids, m in batches]
    cos = min(float((F.normalize(mean_pool(g, m).float(), dim=-1)
                     * F.normalize(mean_pool(r, m).float(), dim=-1)).sum(1).min())
              for (_, m), g, r in zip(batches, got, ref))
    diff = torch.cat([(g.float() - r.float()).abs()[m.bool()] for (_, m), g, r in
                      zip(batches, got, ref)])
    log(f"ALBERT attention_impl='packed' [{card}]: K7 launches {k7} (12 iterations x "
        f"{len(batches)} batches = {12 * len(batches)}); last_hidden_state against the reference "
        f"path mean|Δ| {float(diff.mean()):.3e}, max|Δ| {float(diff.max()):.3e}; pooled min "
        f"cosine {cos:.6f}")
    if k7 != 12 * len(batches):
        raise AssertionError(f"K7 launched {k7} times, expected 12 x {len(batches)}")
    if cos < 0.99:
        raise AssertionError(f"ALBERT's K7 path and reference path disagree (min cosine {cos})")

    # the shared leaf's gradient: the sum over its 12 iterations
    f32 = arch.replace(hidden_dropout=0.0, attention_dropout=0.0)
    pairs = [(texts[i], texts[i + 1]) for i in range(0, 16, 2)]
    batch = batch_to(build_pair_batches(tok, pairs, np.linspace(0, 1, 8, dtype=np.float32),
                                        batch_size=8, max_len=64)[0], torch.device("cuda"))

    def repeat(tree):
        return {k: repeat(v) if isinstance(v, dict) else v.repeat(12, *[1] * (v.dim() - 1))
                for k, v in tree.items()}

    shared = trainable({"encoder": params}, torch.device("cuda"))
    unshared = trainable({"encoder": {**params, "layers": repeat(params["layers"])}},
                         torch.device("cuda"))
    _, _, g_s = value_and_grad(bi_encoder_loss, shared, batch, arch=f32,
                               precision=FP32_PRECISION, deterministic=True)
    _, _, g_u = value_and_grad(bi_encoder_loss, unshared, batch,
                               arch=f32.replace(share_layers=False),
                               precision=FP32_PRECISION, deterministic=True)
    g_s, g_u = flat_leaves(g_s), flat_leaves(g_u)
    g_u = {k: g.sum(dim=0, keepdim=True) if k.startswith("encoder/layers/") else g
           for k, g in g_u.items()}
    # a leaf whose exact gradient is zero (the key bias: a shift shared by
    # a row's scores leaves the softmax alone) is measured against 1e-3 of
    # the whole gradient's norm, as phase 7 does
    whole = sum(float(g.norm()) ** 2 for g in g_u.values()) ** 0.5
    rel = {k: float((g_s[k] - g).norm()) / max(float(g.norm()), 1e-3 * whole)
           for k, g in g_u.items()}
    floored = [k for k, g in g_u.items() if float(g.norm()) < 1e-3 * whole]
    worst_leaf = max(rel, key=rel.get)
    log(f"ALBERT shared-layer gradient (f32, dropout 0, 8 pairs at 64) [{card}]: per leaf "
        f"‖g_shared − Σ g_unshared‖ / ‖Σ g_unshared‖ max {rel[worst_leaf]:.2e} ({worst_leaf}), "
        f"median {float(np.median(list(rel.values()))):.2e}, limit {ALBERT_GRAD_REL:.0e}; "
        f"against 1e-3 of the whole norm: {floored}")
    if rel[worst_leaf] > ALBERT_GRAD_REL:
        raise AssertionError(f"the shared layer's gradient is not the sum over its iterations: "
                             f"{worst_leaf} {rel[worst_leaf]:.2e}")
    return rates


def packed_train_records(torch, card, ctx, words):
    """bench.py's packed-train recipe in this process (minilm-l6, 8,192
    pairs of its length law as token rows, 64 rows of 128 a side, cosine
    MSE, ``remat=True``; a warm epoch, then one timed) → pairs/s; then the
    packed step's gradient against the bucketed step's on 64 pairs."""
    from text_similarity_tpu_torch.core.config import ARCH_PRESETS, TrainConfig
    from text_similarity_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from text_similarity_tpu_torch.data import (
        build_packed_pair_batches, build_pair_batches, packed_pair_batches_from_rows,
    )
    from text_similarity_tpu_torch.train import (
        init_train_state, make_optimizer, make_packed_bi_encoder_train_step,
    )
    from text_similarity_tpu_torch.train.steps import (
        batch_to, bi_encoder_loss, packed_bi_encoder_loss, trainable, value_and_grad,
    )

    arch = ARCH_PRESETS["minilm-l6"]
    rng = np.random.RandomState(17)
    n = 8192
    lens = np.clip(np.round(np.exp(rng.normal(3.1, 0.45, 2 * n))).astype(int), 6, 126)
    rows = [list(rng.randint(5, arch.vocab_size, length + 2)) for length in lens]
    batches = packed_pair_batches_from_rows(rows[:n], rows[n:], rng.rand(n).astype(np.float32),
                                            rows_per_side=64, width=128, shuffle=False)
    dev = torch.device("cuda")
    batches = [batch_to(b, dev) for b in batches]
    from text_similarity_tpu_torch.models import init_params

    params = init_params(arch, torch.Generator().manual_seed(3))
    tx = make_optimizer(TrainConfig(), len(batches))
    step = make_packed_bi_encoder_train_step(arch, tx, loss_type="cosine_mse", remat=True)

    def epoch():
        st = init_train_state({"encoder": params}, tx, device="cuda")
        torch.cuda.synchronize()
        t = time.time()
        for b in batches:
            st, m = step(st, b)
        loss = float(m["loss"])
        return time.time() - t, loss

    epoch()                                       # warm
    dt, loss = epoch()
    log(f"packed train step, bench.py's recipe (minilm-l6, {n} pairs in {len(batches)} steps of "
        f"64 rows x 128 a side, cosine MSE, remat=True, bf16) [{card}]: {n / dt:.0f} pairs/s "
        f"({dt * 1e3 / len(batches):.1f} ms/step), last loss {loss:.4f} (a record, not a gate)")
    st = init_train_state({"encoder": params}, tx, device="cuda")
    profile_split(torch, "one packed train step (bench.py's recipe)",
                  lambda: step(st, batches[0]), card,
                  groups=(("GEMMs", ("gemm", "nvjet", "xmma", "cutlass")),))

    # packed against bucketed, the same 64 pairs, dropout 0
    f0 = arch.replace(hidden_dropout=0.0, attention_dropout=0.0)   # phase 4's weights
    tok = ctx["tok"]
    sents = bench_length_rows(np.random.default_rng(5), words, 128)
    pairs = list(zip(sents[:64], sents[64:]))
    target = np.random.default_rng(6).random(64).astype(np.float32)
    dense = build_pair_batches(tok, pairs, target, batch_size=64, max_len=128, shuffle=False)
    packed = build_packed_pair_batches(tok, pairs, target, rows_per_side=64, width=128,
                                       shuffle=False)
    if len(dense) != 1 or len(packed) != 1:
        raise AssertionError("the 64 pairs do not fit one dense and one packed batch")
    leaves = trainable({"encoder": ctx["params"]}, dev)
    readings = {}
    for name, precision, limit in (("f32", FP32_PRECISION, GRAD_F32),
                                   ("bf16", DEFAULT_PRECISION, GRAD_BF16)):
        kw = dict(arch=f0, precision=precision, deterministic=True)
        ld, _, gd = value_and_grad(bi_encoder_loss, leaves, batch_to(dense[0], dev), **kw)
        lp, _, gp = value_and_grad(packed_bi_encoder_loss, leaves, batch_to(packed[0], dev), **kw)
        gd, gp = flat_leaves(gd), flat_leaves(gp)
        whole = sum(float(v.norm()) ** 2 for v in gd.values()) ** 0.5
        rel = {k: float((gp[k].float() - v.float()).norm()) / max(float(v.norm()), 1e-3 * whole)
               for k, v in gd.items()}
        worst = max(rel, key=rel.get)
        readings[name] = (rel[worst], limit)
        log(f"packed vs bucketed step gradient {name} (64 pairs, minilm-l6, dropout 0) [{card}]: "
            f"loss {float(lp.detach()):.6f} vs {float(ld.detach()):.6f}; per leaf ‖Δg‖/‖g‖ max {rel[worst]:.3e} "
            f"({worst}), median {float(np.median(list(rel.values()))):.3e} (limit {limit})")
    for name, (worst, limit) in readings.items():
        if worst > limit:
            raise AssertionError(f"{name}: the packed step's gradient differs from the bucketed "
                                 f"step's by {worst:.3e} > {limit}")
    return n / dt


def phase_training_entry_points(torch, card, ctx):
    """ALBERT, then the CLI's training and evaluation commands in this
    process with ``--device cuda`` on data files written from phase 4's
    corpus, then ``pretrain-long`` at 4096 (K5 / K6 counted)."""
    import tempfile

    from text_similarity_tpu_torch.models import SentenceEncoder
    from text_similarity_tpu_torch.models.cross_encoder import CrossEncoder
    from text_similarity_tpu_torch.ops.attention import (
        flash_attention_backward_cuda, flash_attention_cuda,
    )
    from text_similarity_tpu_torch.pipelines import RankingPipeline
    import text_similarity_tpu_torch.train as train_mod

    records = {"albert": albert_records(torch, card, ctx)}
    tok, corpus = ctx["tok"], ctx["corpus"]
    words = sorted({w for s in corpus[:5000] for w in s.split()})
    records["packed_step_pps"] = packed_train_records(torch, card, ctx, words)

    rng = np.random.default_rng(10)
    build = os.path.join(REPO, "text_similarity_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        def path(name):
            return os.path.join(tmp, name)

        tok.save_vocab(path("vocab.txt"))
        common = ["--arch", "minilm-l6", "--tokenizer", tmp, "--device", "cuda", "--epochs", "1"]
        # train-sts --packed: 8,192 pairs of bench.py's length law
        sents = bench_length_rows(rng, words, 2 * 8192)
        with open(path("sts.tsv"), "w") as f:
            f.writelines(f"{a}\t{b}\t{s:.3f}\n" for a, b, s in
                         zip(sents[:8192], sents[8192:], rng.uniform(0, 5, 8192)))
        dt, out = cli(torch, ["train-sts", "--data", path("sts.tsv"), "--packed", "--packed-rows", "64",
                       "--max-len", "128", "--no-eval", "--save-path", path("sts")] + common,
                      card)
        hist = [json.loads(line) for line in open(path("sts/results.jsonl"))]
        steps, secs, loss = hist[0]["steps"], hist[0]["seconds"], hist[0]["train"]["loss"]
        log(f"train-sts --packed [{card}]: 8192 pairs in {steps} steps, epoch {secs:.2f} s = "
            f"{8192 / secs:.0f} pairs/s ({8192 / dt:.0f} pairs/s over the whole command, "
            f"tokenizing and packing included); mean loss {loss:.5f}")
        if not np.isfinite(loss) or not np.isfinite(out["best_metric"]):
            raise AssertionError(f"train-sts --packed: loss {loss}, best {out['best_metric']}")
        emb = SentenceEncoder.load(path("sts"), device="cuda").encode(sents[:64])
        if emb.shape != (64, 384) or not np.isfinite(emb).all():
            raise AssertionError("the train-sts model does not load and encode")
        records["train_sts_packed_pps"] = 8192 / secs

        # train-cross-encoder, packed and bucketed, then the rerank
        picks = rng.choice(len(corpus), 512, replace=False)
        with open(path("paws.tsv"), "w") as f:
            f.write("id\tsentence1\tsentence2\tlabel\n")
            f.writelines(f"{i}\t{corpus[a]}\t{corpus[b]}\t{i % 2}\n"
                         for i, (a, b) in enumerate(zip(picks[:256], picks[256:])))
        query = ctx["small"].corpus[3]
        for mode in ("packed", "bucketed"):
            extra = ["--packed", "--packed-rows", "16"] if mode == "packed" else []
            cli(torch, ["train-cross-encoder", "--data", path("paws.tsv"), "--format", "paws",
                 "--batch-size", "32", "--max-len", "128", "--save-path", path(f"ce_{mode}")]
                + extra + common, card)
            ce = CrossEncoder.load(path(f"ce_{mode}"), device="cuda")
            ranked = RankingPipeline(ctx["small"], ce, retrieve_k=100)([query], top_k=100)[0]
            cand = [(query, doc) for doc, _, _ in ranked]
            sp = ce.predict(cand, packed=True)
            sb = ce.predict(cand, packed=False)
            err = float(np.abs(sp - sb).max())
            log(f"train-cross-encoder ({mode}) -> CrossEncoder.load -> RankingPipeline [{card}]: "
                f"{len(ranked)} candidates, packed vs bucketed predict max|Δ| {err:.3e} (limit "
                f"{RERANK_AGREE_MAX}), score spread {float(np.std(sb)):.3e}")
            if err > RERANK_AGREE_MAX or not np.isfinite(sp).all() or len(ranked) != 100:
                raise AssertionError(f"the {mode} cross-encoder's rerank disagrees: {err}")

        # train-ner; train-classification then eval-classification
        with open(path("ner.txt"), "w") as f:
            for s in corpus[6000:6256]:
                f.write("\n".join(f"{w} {'B-X' if len(w) % 3 == 0 else 'O'}"
                                  for w in s.split()) + "\n\n")
        _, out = cli(torch, ["train-ner", "--data", path("ner.txt"), "--batch-size", "32",
                      "--save-path", path("ner")] + common, card)
        if not np.isfinite(out["best"]):
            raise AssertionError(f"train-ner: {out}")
        with open(path("docs.jsonl"), "w") as f:
            f.writelines(json.dumps({"text": s, "label": f"c{len(s.split()) % 4}"}) + "\n"
                         for s in corpus[7000:7512])
        _, out = cli(torch, ["train-classification", "--data", path("docs.jsonl"), "--batch-size", "32",
                      "--save-path", path("cls")] + common, card)
        _, ev = cli(torch, ["eval-classification", "--model", path("cls"), "--data", path("docs.jsonl"),
                     "--batch-size", "64", "--device", "cuda"], card)
        log(f"eval-classification [{card}]: accuracy {ev['accuracy']:.4f} over {ev['n']} "
            f"documents, per class {ev['per_class']}")
        if not np.isfinite(out["best"]) or ev["n"] != 512:
            raise AssertionError(f"classification: train {out}, eval {ev}")

        records["pretrain_long"] = pretrain_long_records(torch, card, ctx, tmp, train_mod,
                                                         flash_attention_cuda,
                                                         flash_attention_backward_cuda)
    return records


def pretrain_long_records(torch, card, ctx, tmp, train_mod, k5, k6):
    """``pretrain-long --arch roberta-base --target-len 4096 --window 256
    --batch-size 2`` over 16 documents of 3,000-4,200 tokens (the first
    fills the 4096-token row: the reference's NaN case). The step is
    watched through ``train.make_mlm_train_step``: every loss finite, K5 +12
    and K6 +24 a step (12 layers; window 256 without a global CLS, which
    changes neither count), a parameter moved."""
    tok, corpus = ctx["tok"], ctx["corpus"]
    counts = [len(r) for r in tok.tokenize_many(corpus[:20_000])]
    docs, pos = [], 0
    for target in [4200] + list(np.random.default_rng(11).integers(3000, 4201, 15)):
        parts, total = [], 0
        while total < target:
            parts.append(corpus[pos])
            total += counts[pos]
            pos += 1
        docs.append(" ".join(parts))
    with open(os.path.join(tmp, "long.txt"), "w") as f:
        f.write("\n".join(docs) + "\n")
    n_tokens = int(sum(min(len(r) + 2, 4096) for r in tok.tokenize_many(docs)))

    real = train_mod.make_mlm_train_step
    seen = {"losses": [], "k5": [], "k6": []}

    def watched_factory(*a, **k):
        step = real(*a, **k)

        def watched(state, batch):
            if not seen["losses"]:
                seen["before"] = state.params["encoder"]["layers"]["attn"]["q"]["w"].detach().clone()
                seen["params"] = state.params
                torch.cuda.synchronize()
                seen["t0"] = time.time()
            b5, b6 = k5.launches, k6.launches
            state, m = step(state, batch)
            seen.update(step=step, state=state, batch=batch)
            seen["k5"].append(k5.launches - b5)
            seen["k6"].append(k6.launches - b6)
            seen["losses"].append(m["loss"])
            seen["width"] = int(np.asarray(batch["ids"]).shape[1])
            torch.cuda.synchronize()              # a measurement: the steps' end
            seen["t1"] = time.time()
            return state, m

        return watched

    train_mod.make_mlm_train_step = watched_factory
    torch.cuda.reset_peak_memory_stats()
    k5.launches = k6.launches = 0
    try:
        dt, out = cli(torch, ["pretrain-long", "--arch", "roberta-base", "--tokenizer", tmp, "--data",
                       os.path.join(tmp, "long.txt"), "--target-len", "4096", "--window", "256",
                       "--batch-size", "2", "--save-path", os.path.join(tmp, "long"),
                       "--device", "cuda"], card)
    finally:
        train_mod.make_mlm_train_step = real
    steps_s = seen["t1"] - seen["t0"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in seen["losses"]]
    moved = not torch.equal(seen["params"]["encoder"]["layers"]["attn"]["q"]["w"], seen["before"])
    log(f"pretrain-long roberta-base, target 4096 (table {4096 + 2} rows), window 256, batch 2 "
        f"[{card}]: {len(losses)} steps at width {seen['width']}, losses "
        f"{[f'{x:.4f}' for x in losses]}; K5 a step {seen['k5']}, K6 a step {seen['k6']} "
        f"(expected 12 and 24); {n_tokens} tokens in {steps_s:.2f} s of steps = "
        f"{n_tokens / steps_s:.0f} tokens/s ({n_tokens / dt:.0f} over the whole command); peak "
        f"memory {peak:.2f} GiB; parameters moved: {moved}")
    split = profile_split(torch, "one pretrain-long MLM step (2 x 4096, roberta-base)",
                          lambda: seen["step"](seen["state"], seen["batch"]), card,
                          groups=TRAIN_GROUPS)
    if split is not None:
        k56 = split["K5 flash_fwd"] + split["K6 flash_bwd"]
        log(f"pretrain-long step split [{card}]: K5 {split['K5 flash_fwd']:.2f} ms, K6 "
            f"{split['K6 flash_bwd']:.2f} ms ({k56 / split['busy']:.1%} of the device time), "
            f"GEMMs {split['GEMMs']:.2f} ms; busy {split['busy']:.2f} of {split['wall']:.2f} ms "
            f"wall, idle {1 - split['busy'] / split['wall']:.1%}")
    if len(losses) != 8 or not all(np.isfinite(losses)) or seen["width"] != 4096:
        raise AssertionError(f"pretrain-long: {len(losses)} steps at width {seen['width']}, "
                             f"losses {losses}")
    if any(x != 12 for x in seen["k5"]) or any(x != 24 for x in seen["k6"]):
        raise AssertionError(f"pretrain-long: K5 {seen['k5']}, K6 {seen['k6']} a step")
    if not moved or not np.isfinite(out["mlm_loss_last"]):
        raise AssertionError(f"pretrain-long: parameters moved {moved}, output {out}")
    return {"tokens_per_s": n_tokens / steps_s, "peak_gib": peak, "losses": losses}


# ---------------------------------------------------------------------------
# Phase 11: the main path's commands (mining, encode / search / quantize /
# compare-models through the CLI, the churn and serve-load drives, HF
# conversion, hpo)
# ---------------------------------------------------------------------------

# IVF mining at 1M: recall@10 of the mined neighbours against the exact
# top-10 (phase 3's IVF gate). The IVF route of `mine` must find the planted
# pairs whose copy lies in a slab that the original's query block probes;
# the others are out of reach of the reference's block-union scan
# (union_factor 1), which the port keeps (ROADMAP queue 3). That reach is
# held too: at least PLANTED_PROBED_MIN of the 1,000 pairs must be probed and
# PLANTED_IVF_RAW_MIN of all 1,000 found (538-543 of 1,000 in four runs on
# the H100), and no pair may be found outside the probed set, which would
# mean that `copy_slab_probed`'s plan has drifted from the scan's
MINE_RECALL_MIN = 0.95
PLANTED_IVF_MIN = 0.95
PLANTED_PROBED_MIN = 400
PLANTED_IVF_RAW_MIN = 0.45


def mining_records(torch, card, ctx, corpus):
    """``SentenceMiningPipeline._mine_ivf`` over phase 3's 1M rows at k 10
    (K1, counted), its recall@10 on 4,096 sampled rows against K2's exact
    top-11 less the row itself, and K1 on 256 of the mined rows (four query
    blocks of the first chunk's plan) against its plain version; then
    ``BruteForceIndex.mine`` over 20,000 of the rows (K2, counted) against
    the same mine through the plain ``cosine_topk``."""
    import text_similarity_tpu_torch.index.brute as brute
    from text_similarity_tpu_torch.index import BruteForceIndex, EmbeddingStore
    from text_similarity_tpu_torch.index.ivf import ivf_scan_cuda, ivf_scan_reference
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda, cosine_topk_reference
    from text_similarity_tpu_torch.pipelines import SentenceMiningPipeline

    n, k = corpus.shape[0], 10
    miner = SentenceMiningPipeline(ctx["enc"], device="cuda")
    built = []
    real = miner._mine_with_index
    miner._mine_with_index = lambda ivf, emb, kk: built.append(ivf) or real(ivf, emb, kk)
    ivf_scan_cuda.launches = ivf_scan_cuda.launches_tile = 0
    torch.cuda.synchronize()
    t = time.time()
    s, i = miner._mine_ivf(corpus, k)
    dt = time.time() - t
    k1 = (ivf_scan_cuda.launches, ivf_scan_cuda.launches_tile)
    ivf = built[0]
    rows = np.sort(np.random.default_rng(12).choice(n, 4096, replace=False))
    _, ex = cosine_topk_cuda(corpus[torch.as_tensor(rows, device="cuda")], corpus, k + 1)
    ex = ex.cpu().numpy()
    exact = np.stack([r[r != row][:k] for r, row in zip(ex, rows)])
    recall = overlap(i[rows], exact)
    valid = float((i >= 0).mean())
    log(f"IVF mining (SentenceMiningPipeline._mine_ivf) of {n} x {corpus.shape[1]} rows at k {k} "
        f"[{card}]: {dt:.2f} s = {n / dt:.0f} rows/s, build included (C "
        f"{ivf.num_base_clusters}, Mc {ivf.data_padded.shape[1]}, probes {ivf.config.num_probes}); "
        f"K1 {k1[0]} launches ({k1[1]} on the wgmma tile); recall@10 on 4096 sampled rows "
        f"{recall:.4f} (gate {MINE_RECALL_MIN}); neighbours filled {valid:.4%}")
    if k1[0] == 0 or k1[0] != k1[1]:
        raise AssertionError(f"IVF mining did not run K1 on the tile: {k1}")
    if recall < MINE_RECALL_MIN:
        raise AssertionError(f"IVF mining recall@10 {recall:.4f} < {MINE_RECALL_MIN}")
    # K1 at the shapes mining gives it: the first chunk's plan, k + 1
    q_s, probes, _, block_q = serving_plan(ivf, corpus[:miner.MINE_CHUNK])
    w, slots = ivf.scan_mode(k + 1, 2048 if ivf.data_padded.shape[1] >= 1024 else 0, 0)
    args = (q_s[:256], probes[:256 // block_q], ivf.data_padded, ivf.ids_padded, k + 1, block_q,
            w, slots)
    ks, ki = ivf_scan_cuda(*args)
    rs, ri = ivf_scan_reference(*args)
    check_pair(f"K1 on 256 mined rows (block_q {block_q}, k {k + 1}, deferred w={w} S={slots})",
               ks, ki, rs, ri, card)
    del built, ivf

    # exact mining: K2 against the plain cosine_topk on the same store
    store = EmbeddingStore(20_000, corpus.shape[1], device="cuda")
    store.add(corpus[:20_000])
    cosine_topk_cuda.launches = 0
    torch.cuda.synchronize()
    t = time.time()
    ks, ki = BruteForceIndex(store).mine(k=k)
    dt_exact = time.time() - t
    k2 = cosine_topk_cuda.launches
    kernel = brute.cosine_topk
    brute.cosine_topk = cosine_topk_reference
    try:
        rs, ri = BruteForceIndex(store).mine(k=k)
    finally:
        brute.cosine_topk = kernel
    err = float(np.abs(ks - rs).max())
    ok = k2 > 0 and separated_ids_equal(ki, ri, rs) and err <= 1e-5
    log(f"exact mining (BruteForceIndex.mine, 20000 f32 rows, k {k}) [{card}]: {dt_exact:.2f} s, "
        f"K2 {k2} launches; against the plain cosine_topk: ids equal where separated "
        f"{separated_ids_equal(ki, ri, rs)} ({float((ki == ri).mean()):.4%} equal), "
        f"max|Δscore| {err:.2e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("exact mining on the card disagrees with its plain version")
    return {"ivf_mine_rows_per_s": n / dt, "recall_at_10": recall}


def planted_pairs(lines, planted):
    """Planted texts found as a mined pair: a printed ``score\\ta\\tb`` line
    with a == b (the corpus is otherwise unique)."""
    found = set()
    for line in lines:
        _, a, b = line.split("\t")
        if a == b and a in planted:
            found.add(a)
    return found


def copy_slab_probed(ivf, emb, originals, copies, chunk):
    """For each planted pair: does the query block of the original row (in
    ``_mine_with_index``'s chunk of ``chunk`` rows, planned as
    ``IVFIndex.query`` plans it with the serving args) probe the slab that
    holds the copy?"""
    ids = ivf.ids_padded.cpu().numpy()
    slab_of = np.full(int(ids.max()) + 1, -1)
    r, c = np.nonzero(ids >= 0)
    slab_of[ids[r, c]] = r
    out = np.zeros(len(originals), bool)
    for start in range(0, emb.shape[0], chunk):
        sel = (originals >= start) & (originals < start + chunk)
        if not sel.any():
            continue
        _, probes, order, block_q = serving_plan(ivf, emb[start:start + chunk])
        pos = np.empty(order.numel(), np.int64)
        pos[order.cpu().numpy()] = np.arange(order.numel())
        blocks = pos[originals[sel] - start] // block_q
        probes = probes.cpu().numpy()
        out[sel] = [slab_of[cp] in probes[b] for b, cp in zip(blocks, copies[sel])]
    return out


def cli_records(torch, card, ctx, tmp):
    """The CLI in this process with ``--device cuda`` over a file of phase
    4's 120,000 documents plus 1,000 verbatim copies of corpus lines:
    ``encode`` (bucketed by the "auto" rule and ``--packed``), ``search
    --query`` (the IVF route), ``mine --ivf on`` and ``--ivf off``,
    ``quantize``, ``compare-models``."""
    corpus = ctx["corpus"]
    rng = np.random.default_rng(13)
    picks = rng.choice(len(corpus), 1000, replace=False)
    planted = {corpus[j] for j in picks}
    lines = list(corpus) + [corpus[j] for j in picks]
    docs, enc_dir = os.path.join(tmp, "docs.txt"), os.path.join(tmp, "enc")
    with open(docs, "w") as f:
        f.write("\n".join(lines) + "\n")
    ctx["enc"].save(enc_dir)
    dev = ["--model", enc_dir, "--device", "cuda"]
    rec = {}

    # encode, with and without --packed
    embs = {}
    for mode, extra in (("auto", []), ("packed", ["--packed"])):
        out = os.path.join(tmp, f"emb_{mode}.npy")
        dt, printed = cli_lines(torch, ["encode", "--corpus", docs, "--out", out] + dev + extra)
        embs[mode] = np.load(out)
        rec[f"encode_{mode}_rows_per_s"] = len(lines) / dt
        log(f"  encode ({'--packed' if extra else 'the auto rule'}): {dt:.1f} s = "
            f"{len(lines) / dt:.0f} rows/s -> {printed[-1]} [{card}]")
    a, b = embs["auto"], embs["packed"]
    cos = (a * b).sum(axis=1)
    worst = float(np.abs(a - b).max())
    ok = (a.shape == b.shape == (len(lines), 384) and 1.0 - cos.min() <= PACK_AGREE_COS
          and worst <= PACK_AGREE_MAX)
    log(f"encode .npy, the auto rule against --packed: 1 − min cosine {1.0 - cos.min():.2e}, "
        f"max|Δ| {worst:.3e} (limits {PACK_AGREE_COS:.1e}, {PACK_AGREE_MAX:.1e}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("encode's two routes disagree")

    # search --query: a corpus line with no planted copy must come back first
    query = next(t for t in corpus[5000:] if t not in planted)
    dt, printed = cli_lines(torch, ["search", "--corpus", docs, "--query", query] + dev)
    first = printed[0].split("\t", 1)
    log(f"  search --query over {len(lines)} lines (IVF route, C 1024, 16 probes): {dt:.1f} s "
        f"(encode and build included); first {first[0]} {'itself' if first[1] == query else 'another'}")
    if first[1] != query or float(first[0]) < 0.99 or len(printed) != 10:
        raise AssertionError(f"search --query did not return the line first: {printed[:2]}")

    # mine: every planted pair by the exact route; by the IVF route, those
    # whose copy lies in a slab the original's query block probes (the
    # command's own index and rows, seen through _mine_with_index)
    from text_similarity_tpu_torch.pipelines import SentenceMiningPipeline

    found, seen = {}, []
    real = SentenceMiningPipeline._mine_with_index
    SentenceMiningPipeline._mine_with_index = (
        lambda self, ivf, emb, k: seen.append((ivf, emb)) or real(self, ivf, emb, k))
    try:
        for route in ("on", "off"):
            dt, printed = cli_lines(torch, ["mine", "--corpus", docs, "--ivf", route, "--top-k",
                                            "3", "--min-score", "0.99", "--max-pairs",
                                            "100000000"] + dev)
            found[route] = planted_pairs(printed, planted)
            rec[f"mine_ivf_{route}_seconds"] = dt
            log(f"  mine --ivf {route} --top-k 3 --min-score 0.99: {dt:.1f} s, {len(printed)} "
                f"pairs printed, planted pairs found {len(found[route])}/1000 [{card}]")
    finally:
        SentenceMiningPipeline._mine_with_index = real
    ivf, emb = seen[0]
    copies = len(corpus) + np.arange(1000)
    probed = copy_slab_probed(ivf, emb, picks, copies, SentenceMiningPipeline.MINE_CHUNK)
    hit = np.array([corpus[j] in found["on"] for j in picks])
    reach = int((hit & probed).sum())
    stray = int((hit & ~probed).sum())
    log(f"mine --ivf on [{card}]: planted pairs found {int(hit.sum())}/1000 (gate "
        f"{PLANTED_IVF_RAW_MIN}); the copy's slab in the original's block probe list for "
        f"{int(probed.sum())} (gate {PLANTED_PROBED_MIN}), of which {reach} found (gate "
        f"{PLANTED_IVF_MIN}); found though not probed {stray} (gate 0) (C "
        f"{ivf.num_base_clusters}, probes {ivf.config.num_probes}, Mc "
        f"{ivf.data_padded.shape[1]}, overflow slabs {ivf.num_overflow})")
    if (len(found["off"]) != 1000 or probed.sum() < PLANTED_PROBED_MIN
            or reach < PLANTED_IVF_MIN * probed.sum() or hit.sum() < PLANTED_IVF_RAW_MIN * 1000
            or stray):
        raise AssertionError(f"planted pairs found: exact {len(found['off'])}, IVF {reach} of "
                             f"{int(probed.sum())} probed, {int(hit.sum())} in all, {stray} "
                             f"outside the probed set")
    rec["planted_found_ivf"] = int(hit.sum())

    # quantize, then compare-models over 2,000 documents and 100 queries
    small = os.path.join(tmp, "docs2000.txt")
    with open(small, "w") as f:
        f.write("\n".join(corpus[:2000]) + "\n")
    _, out = cli(torch, ["quantize", "--save-path", os.path.join(tmp, "int8")] + dev, card)
    cmp_args = ["compare-models", "--corpus", small, "--num-queries", "100"] + dev
    _, same = cli(torch, cmp_args + ["--student", enc_dir], card)
    _, q8 = cli(torch, cmp_args + ["--student", os.path.join(tmp, "int8")], card)
    log(f"compare-models [{card}]: the model against itself mean overlap "
        f"{same['mean_topk_overlap']:.4f}; the quantize output (loaded dequantized to bf16: "
        f"weight quantization only, as the reference) mean top-10 overlap "
        f"{q8['mean_topk_overlap']:.4f}, min {q8['min_topk_overlap']:.4f} (a record)")
    if same["mean_topk_overlap"] != 1.0 or out["format"] != "int8":
        raise AssertionError(f"compare-models of the model with itself: {same}")
    rec["int8_student_overlap"] = q8["mean_topk_overlap"]
    return rec


def churn_records(torch, card, corpus, queries):
    """The churn drive on phase 3's 1M rows and 4,096 queries, 100,000 new
    rows of the same recipe: post-churn recall@10 ≥ 0.95, no removed id in
    an answer, every re-added row found by its own query."""
    from text_similarity_tpu_torch.drives import churn

    added = churn.new_rows(100_000, corpus.shape[1], seed=0, device="cuda")
    torch.cuda.synchronize()
    t = time.time()
    rows = churn.Churn(corpus, queries, added, windows=3, iters=3,
                       emit=lambda row: log(f"  churn {json.dumps(row)}")).run()
    post, leak, readd = rows["post_churn"], rows["tombstone_leak_check"], rows["readd_self_check"]
    log(f"churn drive at {corpus.shape[0]} rows [{card}]: {time.time() - t:.1f} s; remove "
        f"{rows['remove']['rows_per_s']:.0f} rows/s, add {rows['add_1x100000']['rows_per_s']:.0f} "
        f"rows/s (1 x 100000), {rows['add_10x10000']['rows_per_s']:.0f} (10 x 10000); recall@10 "
        f"fresh {rows['fresh']['recall_at_10']:.4f}, post-churn {post['recall_at_10']:.4f}, rebuild "
        f"{rows['rebuild']['recall_at_10']:.4f}; QPS medians {rows['fresh']['qps_median']:.0f} / "
        f"{post['qps_median']:.0f} / {rows['rebuild']['qps_median']:.0f}; leaked {leak['leaked']}; "
        f"re-added rows found {readd['found_top10']}/{readd['rows']} (first {readd['found_first']})")
    if post["recall_at_10"] < 0.95 or leak["leaked"] or readd["found_top10"] != readd["rows"]:
        raise AssertionError(f"churn: {post}, {leak}, {readd}")
    return rows


def serve_load_records(torch, card, ctx):
    """The serve-load drive's phases A-D against phase 4's 120,000-document
    pipeline and phase 9's cross-encoder (retrieve_k 100), 3 s a phase:
    every request answered."""
    from text_similarity_tpu_torch.drives import serve_load
    from text_similarity_tpu_torch.pipelines import RankingPipeline

    rr = RankingPipeline(ctx["big"], ctx["ce"], retrieve_k=100, batch_size=512)
    rows = serve_load.run_phases(ctx["big"], rr, ctx["corpus"][:65536], duration=3.0,
                                 phases="ABCD", rerank_factor=1.0,
                                 emit=lambda row: log(f"  serve_load {json.dumps(row)[:400]}"))
    for r in rows:
        log(f"serve_load {r['phase']} [{card}]: {r['queries_per_s']:.1f} queries/s over "
            f"{r['requests']} requests of {r['batch']} ({r['clients']} clients), p50 "
            f"{r['p50_ms']} ms, p95 {r['p95_ms']} ms, errors {r['errors']}")
    if any(r["errors"] or not r["requests"] for r in rows):
        raise AssertionError("serve_load: a request was not answered")
    return {r["phase"]: {"qps": r["queries_per_s"], "p50_ms": r["p50_ms"], "p95_ms": r["p95_ms"]}
            for r in rows}


def hf_state_dict(params, layers):
    """Phase 4's minilm-l6 tree under HuggingFace BERT's key names, as a
    numpy state dict ((out, in) weights): the inverse of
    ``convert_state_dict``."""
    def np_(t):
        return t.detach().float().cpu().numpy()

    emb, lay = params["embeddings"], params["layers"]
    sd = {
        "embeddings.word_embeddings.weight": np_(emb["word"]),
        "embeddings.position_embeddings.weight": np_(emb["position"]),
        "embeddings.token_type_embeddings.weight": np_(emb["token_type"]),
        "embeddings.LayerNorm.weight": np_(emb["ln"]["scale"]),
        "embeddings.LayerNorm.bias": np_(emb["ln"]["bias"]),
        "pooler.dense.weight": np_(params["pooler"]["w"]).T,
        "pooler.dense.bias": np_(params["pooler"]["b"]),
    }
    names = {("attn", "q"): "attention.self.query", ("attn", "k"): "attention.self.key",
             ("attn", "v"): "attention.self.value", ("attn", "o"): "attention.output.dense",
             ("mlp", "in"): "intermediate.dense", ("mlp", "out"): "output.dense"}
    lns = {"attn_ln": "attention.output.LayerNorm", "mlp_ln": "output.LayerNorm"}
    for i in range(layers):
        for (grp, name), hf in names.items():
            sd[f"encoder.layer.{i}.{hf}.weight"] = np_(lay[grp][name]["w"][i]).T
            sd[f"encoder.layer.{i}.{hf}.bias"] = np_(lay[grp][name]["b"][i])
        for grp, hf in lns.items():
            sd[f"encoder.layer.{i}.{hf}.weight"] = np_(lay[grp]["scale"][i])
            sd[f"encoder.layer.{i}.{hf}.bias"] = np_(lay[grp]["bias"][i])
    return {"bert." + key: v for key, v in sd.items()}


def hf_records(torch, card, ctx):
    """Phase 4's minilm-l6 weights under HF's key names back through
    ``convert_state_dict`` into a ``SentenceEncoder`` on the card: its
    embeddings of 256 corpus texts equal phase 4's bit for bit; the
    leftovers: ``embed_token_stack`` equals ``embed_tokens`` batch by batch."""
    from text_similarity_tpu_torch.models import SentenceEncoder, convert_state_dict, num_params

    enc, texts = ctx["enc"], ctx["corpus"][:256]
    params = convert_state_dict(hf_state_dict(enc.params, enc.arch.num_layers), enc.arch,
                                family="bert", device="cuda")
    hf = SentenceEncoder(params, enc.arch, tokenizer=ctx["tok"], device="cuda")
    want, again, got = enc.encode(texts), enc.encode(texts), hf.encode(texts)
    log(f"HF round trip (minilm-l6, {num_params(params)} parameters, HF key names -> "
        f"convert_state_dict -> SentenceEncoder) [{card}]: 256 embeddings bit-equal "
        f"{np.array_equal(got, want)} (max|Δ| {float(np.abs(got - want).max()):.2e}; phase 4's "
        f"encoder against itself bit-equal {np.array_equal(again, want)})")
    if not np.array_equal(got, want):
        raise AssertionError("the HF round trip changed the embeddings")
    ids, mask = ctx["tok"].encode_batch(texts, 64)
    stack = enc.embed_token_stack(ids.reshape(4, 64, 64), mask.reshape(4, 64, 64))
    each = torch.stack([enc.embed_tokens(ids[j * 64:(j + 1) * 64], mask[j * 64:(j + 1) * 64])
                        for j in range(4)])
    log(f"embed_token_stack (4 x 64 x 64) against embed_tokens batch by batch: equal "
        f"{torch.equal(stack, each)}")
    if not torch.equal(stack, each):
        raise AssertionError("embed_token_stack differs from embed_tokens")


def hpo_records(torch, card, ctx):
    """A 4-trial ``AdaptiveParamOptimizer`` over lr, each trial 5 steps of
    minilm-l6 (phase 4's weights, cosine MSE on 32 corpus pairs); the
    objective is the last step's loss (direction min)."""
    from text_similarity_tpu_torch.core.config import TrainConfig
    from text_similarity_tpu_torch.data.pairs import build_pair_batches
    from text_similarity_tpu_torch.train import (
        init_train_state, make_bi_encoder_train_step, make_optimizer,
    )
    from text_similarity_tpu_torch.train.hpo import AdaptiveParamOptimizer, SearchSpace

    corpus, enc = ctx["corpus"], ctx["enc"]
    rng = np.random.default_rng(14)
    picks = rng.choice(len(corpus), 64, replace=False)
    pairs = [(corpus[i], corpus[j]) for i, j in zip(picks[:32], picks[32:])]
    batch = build_pair_batches(ctx["tok"], pairs, rng.random(32).astype(np.float32),
                               batch_size=32, max_len=128)[0]
    losses = []

    def objective(p):
        tx = make_optimizer(TrainConfig(lr=p["lr"], warmup_ratio=0.0), 5,
                            params_example={"encoder": ctx["params"]})
        state = init_train_state({"encoder": ctx["params"]}, tx, device="cuda")
        step = make_bi_encoder_train_step(enc.arch, tx, loss_type="cosine_mse")
        for _ in range(5):
            state, m = step(state, batch)
        trial = [float(m["loss"])]
        losses.append(trial[0])
        return trial[0]

    t = time.time()
    res = AdaptiveParamOptimizer(objective, SearchSpace({"lr": ("loguniform", 1e-6, 1e-3)}),
                                 direction="min", seed=0).optimize(n_trials=4)
    log(f"hpo [{card}]: 4 trials x 5 minilm-l6 steps in {time.time() - t:.1f} s; losses "
        f"{[f'{x:.5f}' for x in losses]}; best lr {res['best_params']['lr']:.3e} -> "
        f"{res['best_value']:.5f}")
    if len(losses) != 4 or not np.all(np.isfinite(losses)):
        raise AssertionError(f"hpo: losses {losses}")


def phase_commands(torch, card, ctx, corpus, queries):
    """Phase 11, with K1's and K2's counters zeroed just before: IVF and
    exact mining, the CLI's remaining commands, the churn and serve-load
    drives, the HF round trip and the leftovers, hpo."""
    import tempfile

    from text_similarity_tpu_torch.index.ivf import ivf_scan_cuda
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda

    records = {"mining": mining_records(torch, card, ctx, corpus)}
    ivf_scan_cuda.launches = cosine_topk_cuda.launches = 0
    build = os.path.join(REPO, "text_similarity_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        records["cli"] = cli_records(torch, card, ctx, tmp)
    records["churn"] = churn_records(torch, card, corpus, queries)
    records["serve_load"] = serve_load_records(torch, card, ctx)
    k1, k2 = ivf_scan_cuda.launches, cosine_topk_cuda.launches
    log(f"launches during the commands, the drives: K1 {k1}, K2 {k2}")
    if k1 == 0 or k2 == 0:
        raise AssertionError(f"the commands did not run K1 and K2: K1 {k1}, K2 {k2}")
    hf_records(torch, card, ctx)
    hpo_records(torch, card, ctx)
    return records


# ---------------------------------------------------------------------------
# Phase 12: compression, clustering, topics and word models
# ---------------------------------------------------------------------------

# the theseus mixed forward against the plain stacks it reduces to at rate 1
# (the student) and 0 (the teacher), bf16 on the card: the same layers run
# in the same order, so any difference is a fault; the limit is one bf16 ulp
# at the states' largest magnitudes (about 8)
THESEUS_BF16 = 2 ** -5
# head / FFN importance on the card against the CPU, f32: max |Δ| over the
# largest importance of the matrix (the normalised importances are ≤ 1)
IMPORTANCE_REL = 1e-3
# pruned logits against the unpruned model's with the matching 0/1 head
# mask, f32 on the card: the dropped heads' products are exact zeros in one
# and absent in the other, so only the order of the output projection's
# sums differs
PRUNE_F32 = 1e-4


def k2_held(torch, q, c, ks, label, card):
    """K2 against its plain version on the card's (q, c) at each k of
    ``ks``, as phase 2 holds it (f32: ids equal where the scores are
    separated, the last rank from the plain version's (k + 1)-th score too,
    max |Δscore| ≤ 1e-5); these launches leave K2's counter as it was."""
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda, cosine_topk_reference

    count = cosine_topk_cuda.launches
    for k in ks:
        ks_, ki = cosine_topk_cuda(q, c, k)
        rs, ri = cosine_topk_reference(q, c, k + 1)
        nxt = rs[:, k].cpu().numpy()
        err, ok, detail = agree_topk(ks_, ki, rs[:, :k], ri[:, :k], exact=True, next_scores=nxt)
        log(f"  K2 at {label}: Q {q.shape[0]} x N {c.shape[0]} x D {c.shape[1]} f32, k {k}: "
            f"max|Δscore| {err:.2e}, {detail} -> {'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version at {label}, k {k}")
    cosine_topk_cuda.launches = count


def self_retrieval(torch, enc, loaded, docs, card):
    """The in-memory encoder's embeddings of ``docs`` as a store, the loaded
    copy's as queries: K2's top-1 → (documents found first at score ≥ 0.99,
    the smallest top-1 score). K2 is held to its plain version on the same
    store and queries at the k the query gives it (2k, for tombstones) and
    at k 1."""
    from text_similarity_tpu_torch.index import BruteForceIndex, EmbeddingStore
    from text_similarity_tpu_torch.ops.topk import l2_normalize

    store = EmbeddingStore(len(docs), enc.embedding_dim, device="cuda")
    store.add(enc.encode(docs, device_output=True))
    q = loaded.encode(docs, device_output=True)
    s, i = BruteForceIndex(store).query(q, k=1)
    k2_held(torch, l2_normalize(q), store.view, (2, 1), "the student's self-retrieval", card)
    s, i = np.asarray(s)[:, 0], np.asarray(i)[:, 0]
    return int(((i == np.arange(len(docs))) & (s >= 0.99)).sum()), float(s.min())


class EpochLosses(logging.Handler):
    """The (first step's loss, mean of the last 10) of each epoch line a
    sentence distiller logs ("<label> epoch <n>: mse <first> -> <last>")."""

    def __init__(self):
        super().__init__()
        self.epochs = []

    def emit(self, record):
        if " epoch %d: mse " in str(record.msg):
            self.epochs.append((float(record.args[-2]), float(record.args[-1])))


def loss_fell(label, first, last, steps, card):
    log(f"  {label} [{card}]: {steps} steps, loss first {first:.6f}, mean of the last 10 "
        f"{last:.6f}")
    if not (np.isfinite(first) and np.isfinite(last) and last < first):
        raise AssertionError(f"{label}: the loss did not fall ({first} -> {last})")


def distill_records(torch, card, ctx, tmp):
    """SentenceEncoderDistiller (3 of 6 layers), DimReducingDistiller (128
    dimensions) and FastFormersDistiller (a minilm-l6 classifier)."""
    from text_similarity_tpu_torch.compress.distill import (
        DimReducingDistiller, FastFormersDistiller, SentenceEncoderDistiller,
    )
    from text_similarity_tpu_torch.core.config import TrainConfig
    from text_similarity_tpu_torch.data.pairs import build_sequence_batches
    from text_similarity_tpu_torch.models import SentenceEncoder
    from text_similarity_tpu_torch.train import init_classifier_head

    enc, corpus = ctx["enc"], ctx["corpus"]
    sents = corpus[20_000:28_192]
    cfg = TrainConfig(lr=1e-4, epochs=1, batch_size=64)
    rec = {}
    for label, make in (
        ("distill", lambda: SentenceEncoderDistiller(enc, num_student_layers=3,
                                                     train_config=cfg)),
        ("dim-reducing distill", lambda: DimReducingDistiller(enc, 128, num_student_layers=3,
                                                              train_config=cfg)),
    ):
        losses = EpochLosses()
        distill_log = logging.getLogger("text_similarity_tpu_torch.distill")
        distill_log.addHandler(losses)
        try:
            torch.cuda.synchronize()
            t = time.time()
            student = make().distill(sents)
            torch.cuda.synchronize()
            dt = time.time() - t
        finally:
            distill_log.removeHandler(losses)
        log(f"{label}: 8192 sentences, teacher minilm-l6 -> {student.arch.num_layers} layers, "
            f"{student.embedding_dim} dimensions, in {dt:.2f} s = {8192 / dt:.0f} sentences/s "
            f"(teacher targets included) [{card}]")
        ((first, last),) = losses.epochs
        loss_fell(label, first, last, 8192 // 64, card)
        rec[label] = 8192 / dt
        if label == "distill":
            student.save(os.path.join(tmp, "student"))
            loaded = SentenceEncoder.load(os.path.join(tmp, "student"), device="cuda")
            found, low = self_retrieval(torch, student, loaded, corpus[:2000], card)
            log(f"  the saved student loaded: K2 finds {found}/2000 documents first at score "
                f">= 0.99 (lowest top-1 score {low:.6f})")
            if found != 2000:
                raise AssertionError(f"the distilled student found {found}/2000 documents")

    # FastFormers: a minilm-l6 classifier (phase 4's weights, a random head)
    # distilled to 3 layers on 2,048 documents of 4 classes
    docs = corpus[30_000:32_048]
    batches = build_sequence_batches(ctx["tok"], docs, [len(d.split()) % 4 for d in docs],
                                     batch_size=32, max_len=128, seed=0)
    teacher = {"encoder": enc.params,
               "head": init_classifier_head(torch.Generator().manual_seed(3),
                                            enc.arch.hidden_size, 4, device="cuda")}
    torch.cuda.synchronize()
    t = time.time()
    _, history = FastFormersDistiller(teacher, enc.arch, num_student_layers=3,
                                      train_config=TrainConfig(lr=1e-4, epochs=1)).distill(batches)
    dt = time.time() - t
    log(f"FastFormers: minilm-l6 classifier -> 3 layers, {len(batches)} batches of 32 in "
        f"{dt:.2f} s = {2048 / dt:.0f} documents/s; kl {history[0]['kl']:.5f} -> "
        f"{history[-1]['kl']:.5f}, state mse {history[0]['state_mse']:.5f} -> "
        f"{history[-1]['state_mse']:.5f} [{card}]")
    losses = [h["loss"] for h in history]
    loss_fell("FastFormers", losses[0], float(np.mean(losses[-10:])), len(losses), card)
    rec["fastformers_docs_per_s"] = 2048 / dt
    return rec


def theseus_records(torch, card, ctx, tmp, dev):
    """``theseus`` through the CLI, its student searched; the mixed forward
    at rates 1 and 0 against the plain stacks."""
    from text_similarity_tpu_torch.compress.theseus import theseus_encoder_forward
    from text_similarity_tpu_torch.models import SentenceEncoder, encoder_forward

    corpus, enc = ctx["corpus"], ctx["enc"]
    rng = np.random.default_rng(15)
    picks = rng.choice(len(corpus), 8192, replace=False)
    with open(os.path.join(tmp, "paws.tsv"), "w") as f:
        f.write("id\tsentence1\tsentence2\tlabel\n")
        f.writelines(f"{i}\t{corpus[a]}\t{corpus[b]}\t{i % 2}\n"
                     for i, (a, b) in enumerate(zip(picks[:4096], picks[4096:])))
    dt, out = cli(torch, ["theseus", "--data", os.path.join(tmp, "paws.tsv"), "--slots", "3",
                          "--batch-size", "64", "--lr", "1e-4", "--save-path",
                          os.path.join(tmp, "theseus")] + dev, card)
    log(f"theseus: 4096 pairs (64 steps of 64) in {dt:.2f} s = {4096 / dt:.0f} pairs/s over the "
        f"whole command [{card}]")
    student = SentenceEncoder.load(os.path.join(tmp, "theseus"), device="cuda")
    found, low = self_retrieval(torch, student, student, corpus[:2000], card)
    log(f"  the theseus student ({student.arch.num_layers} layers) loaded: K2 finds "
        f"{found}/2000 documents first at score >= 0.99 (lowest top-1 score {low:.6f})")
    if out["layers"] != 3 or student.arch.num_layers != 3 or found != 2000:
        raise AssertionError(f"theseus: {out}, {found}/2000 found")

    params = enc.params
    ids, mask = ctx["tok"].encode_batch(corpus[40_000:40_064], 128)
    ids, mask = torch.as_tensor(ids).cuda(), torch.as_tensor(mask).cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        mixed = {rate: theseus_encoder_forward(
            params["layers"], student.params["layers"], params["embeddings"], ids, mask,
            arch=enc.arch, replace_rate=rate, generator=g, precision=enc.precision).float()
            for rate in (1.0, 0.0)}
        plain_student = student.encoder(ids, mask).last_hidden_state.float()
        plain_teacher = encoder_forward(params, ids, mask, arch=enc.arch,
                                        precision=enc.precision).last_hidden_state.float()
    valid = mask.bool()
    e1 = float((mixed[1.0] - plain_student).abs()[valid].max())
    e0 = float((mixed[0.0] - plain_teacher).abs()[valid].max())
    apart = float((plain_student - plain_teacher).abs()[valid].max())
    log(f"  theseus mixed forward, 64 x 128 bf16 [{card}]: rate 1 vs the student's "
        f"encoder_forward max|Δ| {e1:.3e}, rate 0 vs the teacher's {e0:.3e} (limit "
        f"{THESEUS_BF16:.3e}); the two plain stacks apart by max|Δ| {apart:.3e}")
    if e1 > THESEUS_BF16 or e0 > THESEUS_BF16 or apart <= THESEUS_BF16:
        raise AssertionError(f"theseus forward: rate 1 {e1}, rate 0 {e0}, apart {apart}")
    return {"theseus_pairs_per_s": 4096 / dt}


def prune_records(torch, card, ctx, tmp):
    """Importance on the card against the CPU; 12 → 8 heads against the
    head-masked model; ``prune`` → ``eval-classification``."""
    from text_similarity_tpu_torch.compress.prune import (
        ffn_importance, head_importance, prune_rewire,
    )
    from text_similarity_tpu_torch.core import checkpoint as ckpt
    from text_similarity_tpu_torch.core.precision import FP32_PRECISION
    from text_similarity_tpu_torch.data.pairs import build_sequence_batches
    from text_similarity_tpu_torch.train import classifier_forward, init_classifier_head

    enc, corpus, tok = ctx["enc"], ctx["corpus"], ctx["tok"]
    arch = enc.arch
    docs = corpus[50_000:50_256]
    labels = [f"c{len(d.split()) % 3}" for d in docs]
    y = [int(lab[1]) for lab in labels]
    head = init_classifier_head(torch.Generator().manual_seed(4), arch.hidden_size, 3,
                                device="cpu")
    cpu = {"encoder": ctx["params"], "head": head}
    gpu = {"encoder": enc.params, "head": {k: v.cuda() for k, v in head.items()}}
    batches = build_sequence_batches(tok, docs, y, batch_size=32, max_len=128, seed=0)[:8]
    torch.cuda.synchronize()
    t = time.time()
    imp = {"head": head_importance(gpu, arch, batches), "ffn": ffn_importance(gpu, arch, batches)}
    dt = time.time() - t
    ref = {"head": head_importance(cpu, arch, batches), "ffn": ffn_importance(cpu, arch, batches)}
    rel = {k: float(np.abs(imp[k] - ref[k]).max() / np.abs(ref[k]).max()) for k in imp}
    log(f"prune: head (6 x 12) and FFN (6 x 1536) importance over 8 batches of 32 on the card in "
        f"{dt:.2f} s; against the CPU max|Δ| / max|ref|: head {rel['head']:.3e}, ffn "
        f"{rel['ffn']:.3e} (limit {IMPORTANCE_REL}) [{card}]")
    if max(rel.values()) > IMPORTANCE_REL:
        raise AssertionError(f"importance on the card disagrees with the CPU: {rel}")

    pruned, parch = prune_rewire(gpu["encoder"], arch, imp["head"], imp["ffn"], target_heads=8,
                                 target_ffn=arch.intermediate_size)
    hm = np.zeros((arch.num_layers, arch.num_heads), np.float32)
    for i in range(arch.num_layers):
        hm[i, np.argsort(-imp["head"][i])[:8]] = 1.0
    ids, mask = tok.encode_batch(corpus[60_000:60_256], 128)
    ids, mask = torch.as_tensor(ids).cuda(), torch.as_tensor(mask).cuda()
    with torch.no_grad():
        small = classifier_forward({"encoder": pruned, "head": gpu["head"]}, ids, mask,
                                   arch=parch, precision=FP32_PRECISION)
        masked = classifier_forward(gpu, ids, mask, arch=arch, precision=FP32_PRECISION,
                                    head_mask=torch.as_tensor(hm).cuda())
        full = classifier_forward(gpu, ids, mask, arch=arch, precision=FP32_PRECISION)
    err = float((small - masked).abs().max())
    moved = float((small - full).abs().max())
    log(f"  12 -> 8 heads (head_dim_override {parch.head_dim_override}), FFN kept: logits of 256 "
        f"rows against the unpruned model with the 0/1 head mask max|Δ| {err:.3e} (limit "
        f"{PRUNE_F32}); against the unmasked model {moved:.3e}")
    if err > PRUNE_F32 or moved < 10 * PRUNE_F32:
        raise AssertionError(f"pruned logits: {err} against the masked model, {moved} unmasked")

    # prune -> eval-classification through the CLI, from a classifier
    # directory as train-classification writes it
    cls = os.path.join(tmp, "cls")
    ckpt.save_checkpoint(cls, gpu, step=0)
    with open(os.path.join(cls, "arch.json"), "w") as f:
        f.write(arch.to_json())
    with open(os.path.join(cls, "labels.json"), "w") as f:
        json.dump(["c0", "c1", "c2"], f)
    tok.save_vocab(os.path.join(cls, "vocab.txt"))
    with open(os.path.join(tmp, "docs.jsonl"), "w") as f:
        f.writelines(json.dumps({"text": d, "label": lab}) + "\n" for d, lab in zip(docs, labels))
    _, out = cli(torch, ["prune", "--model", cls, "--data", os.path.join(tmp, "docs.jsonl"),
                         "--target-heads", "8", "--target-ffn", "1024", "--save-path",
                         os.path.join(tmp, "pruned"), "--device", "cuda"], card)
    _, ev = cli(torch, ["eval-classification", "--model", os.path.join(tmp, "pruned"), "--data",
                        os.path.join(tmp, "docs.jsonl"), "--batch-size", "64", "--device",
                        "cuda"], card)
    if (out["heads"], out["ffn"]) != (8, 1024) or ev["n"] != 256 or not np.isfinite(ev["accuracy"]):
        raise AssertionError(f"prune -> eval-classification: {out}, {ev}")
    return {"importance_rel": rel}


def export_records(torch, card, ctx, tmp):
    """b 32 × s 128 int8 on the card, reloaded, against the eager int8
    encoder on the same batch."""
    from text_similarity_tpu_torch.compress.export import (
        export_encoder, load_exported_fn, load_exported_params,
    )
    from text_similarity_tpu_torch.models import SentenceEncoder

    enc = ctx["enc"]
    t = time.time()
    manifest = export_encoder(enc, os.path.join(tmp, "bundle"), batch_sizes=(32,),
                              seq_lens=(128,))
    dt = time.time() - t
    (f,) = manifest["functions"]
    fn = load_exported_fn(os.path.join(tmp, "bundle"), f["name"])
    params = load_exported_params(os.path.join(tmp, "bundle"), device="cuda")
    ids_np, mask_np = ctx["tok"].encode_batch(ctx["corpus"][70_000:70_032], 128, pad_to=128)
    ids, mask = torch.as_tensor(ids_np).cuda(), torch.as_tensor(mask_np).cuda()
    eager = SentenceEncoder(ctx["params"], enc.arch, tokenizer=ctx["tok"], device="cuda")
    eager.to_int8()
    got = fn(params, ids, mask)
    want = eager.embed_tokens(ids_np, mask_np)
    err = float((got - want).abs().max())
    with torch.no_grad():
        ms = time_ms(torch, lambda: fn(params, ids, mask))
        eager_ms = time_ms(torch, lambda: eager.embed_tokens(ids_np, mask_np))
    log(f"export: {f['name']} ({f['bytes']} bytes, platforms {f['platforms']}, int8 "
        f"{manifest['int8']}) traced in {dt:.1f} s; reloaded program vs the eager int8 encoder "
        f"max|Δ| {err:.3e} (limit 1e-5); {ms:.3f} ms a call, eager {eager_ms:.3f} ms [{card}]")
    if err > 1e-5 or f["platforms"] != ["cuda"]:
        raise AssertionError(f"export: max|Δ| {err}, platforms {f['platforms']}")
    return {"export_ms": ms, "eager_int8_ms": eager_ms, **long_export_records(torch, card, ctx, tmp)}


def long_export_records(torch, card, ctx, tmp):
    """b 2 × s 4096 int8: phase 6's roberta-base at 4,098 positions (window
    256 + CLS), exported on the card, where the eager encoder runs K5: the
    program carries K5's op. Reloaded on the card it must equal the eager
    int8 encoder (max |Δ| ≤ 1e-5, the short export's gate) and move K5's
    counter by the 12 layers on each call."""
    from text_similarity_tpu_torch.compress.export import (
        export_encoder, load_exported_fn, load_exported_params,
    )
    from text_similarity_tpu_torch.models import SentenceEncoder
    from text_similarity_tpu_torch.ops.attention import flash_attention_cuda

    params, arch = long_arch_params(torch)
    enc = SentenceEncoder(params, arch, tokenizer=ctx["tok"], device="cuda")
    path = os.path.join(tmp, "bundle_4096")
    t = time.time()
    manifest = export_encoder(enc, path, batch_sizes=(2,), seq_lens=(4096,))
    dt = time.time() - t
    (f,) = manifest["functions"]
    fn = load_exported_fn(path, f["name"])
    shipped = load_exported_params(path, device="cuda")
    rng = np.random.default_rng(12)
    docs = long_documents(ctx["tok"], ctx["corpus"][:24_000], rng, 2, 0)
    ids_np, mask_np = ctx["tok"].encode_batch(docs, 4096, pad_to=4096)
    ids, mask = torch.as_tensor(ids_np).cuda(), torch.as_tensor(mask_np).cuda()
    eager = SentenceEncoder(params, arch, tokenizer=ctx["tok"], device="cuda")
    eager.to_int8()
    launches = []
    with torch.no_grad():
        for _ in range(2):
            before = flash_attention_cuda.launches
            got = fn(shipped, ids, mask)
            torch.cuda.synchronize()
            launches.append(flash_attention_cuda.launches - before)
        want = eager.embed_tokens(ids_np, mask_np)
        err = float((got - want).abs().max())
        ms = time_ms(torch, lambda: fn(shipped, ids, mask), iters=5, warmup=1)
        eager_ms = time_ms(torch, lambda: eager.embed_tokens(ids_np, mask_np), iters=5, warmup=1)
    ok = err <= 1e-5 and launches == [arch.num_layers] * 2 and f["platforms"] == ["cuda"]
    log(f"export at 4096: {f['name']} (roberta-base-long int8, {f['bytes']} bytes, lengths "
        f"{mask_np.sum(axis=1).tolist()}) traced in {dt:.1f} s; K5 launches a call {launches} "
        f"(12 layers); reloaded program vs the eager int8 encoder max|Δ| {err:.3e} (limit "
        f"1e-5); {ms:.3f} ms a call, eager {eager_ms:.3f} ms [{card}] -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"export at 4096: max|Δ| {err}, K5 launches {launches}")
    return {"export_4096_ms": ms, "eager_int8_4096_ms": eager_ms}


def wic_rows(rng, corpus, n):
    """WiC-format lines: a word of one corpus sentence put into another at
    a random position; labels alternate."""
    lines, gold = [], []
    for i in range(n):
        a = corpus[100_000 + 2 * i].split()
        b = corpus[100_001 + 2 * i].split()
        i1, i2 = int(rng.integers(len(a))), int(rng.integers(len(b)))
        b[i2] = a[i1]
        lines.append(f"{a[i1]}\tN\t{i1}-{i2}\t{' '.join(a)}\t{' '.join(b)}\n")
        gold.append("T\n" if i % 2 else "F\n")
    return lines, gold


def spectral_density_records(torch, card, ctx):
    """What ``topics --method hdbscan --reduce spectral`` runs on the card,
    held to plain versions: K2 at the k-NN's shape (Q = N = 5,000, k = 15
    neighbours + the row itself) against its plain version, then DBSCAN at
    each radius of the HDBSCAN ladder and the HDBSCAN selection on the
    reduced embeddings against the same calls on the CPU. The reduced rows
    are rounded to multiples of 2^-10 first: every cosine of two such
    32-dimensional rows is then exact in f32 whatever the order of the
    sums, so the thresholded graphs, and the labels, must be equal on both
    devices. The sweeps and clusters at each radius are printed."""
    from text_similarity_tpu_torch.ops import density
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda, l2_normalize
    from text_similarity_tpu_torch.pipelines.topic import spectral_reduce

    emb = ctx["enc"].encode(ctx["corpus"][:5000], batch_size=128, device_output=True)
    x = l2_normalize(emb.float())
    k2_held(torch, x, x, (16,), "topics' spectral k-NN", card)
    count = cosine_topk_cuda.launches
    reduced = l2_normalize(spectral_reduce(emb, 32, n_neighbors=15))
    cosine_topk_cuda.launches = count
    xq = torch.round(reduced * 1024) / 1024
    grid = sorted(density.DEFAULT_EPS_GRID)
    levels = {}
    for where, x in (("card", xq), ("cpu", xq.cpu())):
        t = time.time()
        levels[where] = []
        for eps in grid:
            labels = density.dbscan_cosine(x, eps=eps, min_samples=3)
            levels[where].append(labels)
            log(f"  DBSCAN on the reduced 5000 x 32 [{where}], eps {eps}: "
                f"{density.dbscan_cosine.sweeps} sweeps, {labels.max() + 1} clusters, "
                f"{int((labels < 0).sum())} noise")
        log(f"  the ladder on the {where} in {time.time() - t:.2f} s")
    same = [bool(np.array_equal(a, b)) for a, b in zip(levels["card"], levels["cpu"])]
    card_labels = density.hdbscan_cosine(xq, min_samples=3)
    # hdbscan_cosine(xq.cpu()) is this selection over the CPU's ladder
    cpu_labels = density._stability_select(np.stack(levels["cpu"]), 1.0 / np.asarray(grid),
                                           xq.shape[0])
    log(f"  DBSCAN labels on the card equal the CPU's at each radius: {same}; HDBSCAN "
        f"{card_labels.max() + 1} clusters, {int((card_labels < 0).sum())} noise, equal to "
        f"the CPU's: {np.array_equal(card_labels, cpu_labels)} [{card}]")
    if not all(same) or not np.array_equal(card_labels, cpu_labels):
        raise AssertionError("the density labels on the card differ from the CPU's")


def phase_compression(torch, card, ctx):
    """Phase 12, K2's counter zeroed just before: distillation, theseus,
    pruning, export, ``cluster`` / ``topics`` and ``train-wic``."""
    import tempfile

    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda

    corpus = ctx["corpus"]
    build = os.path.join(REPO, "text_similarity_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    t0 = time.time()
    cosine_topk_cuda.launches = 0
    records = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        enc_dir = os.path.join(tmp, "enc")
        ctx["enc"].save(enc_dir)
        dev = ["--model", enc_dir, "--device", "cuda"]
        records["distill"] = distill_records(torch, card, ctx, tmp)
        records["theseus"] = theseus_records(torch, card, ctx, tmp, dev)
        records["prune"] = prune_records(torch, card, ctx, tmp)
        records["export"] = export_records(torch, card, ctx, tmp)

        with open(os.path.join(tmp, "c20k.txt"), "w") as f:
            f.write("\n".join(corpus[:20_000]) + "\n")
        dt, lines = cli_lines(torch, ["cluster", "--corpus", os.path.join(tmp, "c20k.txt"),
                                      "--num-clusters", "50"] + dev)
        sizes = [json.loads(line)["size"] for line in lines]
        log(f"cluster: 20000 sentences -> {len(sizes)} clusters in {dt:.2f} s (sizes "
            f"{min(sizes)}-{max(sizes)}) [{card}]")
        if sum(sizes) != 20_000 or len(sizes) > 50:
            raise AssertionError(f"cluster: {len(sizes)} clusters holding {sum(sizes)} sentences")
        with open(os.path.join(tmp, "c5k.txt"), "w") as f:
            f.write("\n".join(corpus[:5000]) + "\n")
        for method, reduce in (("kmeans", "pca"), ("hdbscan", "spectral")):
            k2 = cosine_topk_cuda.launches
            dt, lines = cli_lines(torch, ["topics", "--corpus", os.path.join(tmp, "c5k.txt"),
                                          "--num-topics", "10", "--method", method, "--reduce",
                                          reduce] + dev)
            sizes = [int(line.split()[1]) for line in lines]
            noise = sum(n for line, n in zip(lines, sizes) if line.split()[0] == "-1")
            log(f"topics --method {method} --reduce {reduce}: 5000 documents -> {len(lines)} "
                f"topics in {dt:.2f} s ({noise} documents as noise), K2 launches "
                f"{cosine_topk_cuda.launches - k2} [{card}]")
            if sum(sizes) != 5000 or (reduce == "spectral") != (cosine_topk_cuda.launches > k2):
                raise AssertionError(f"topics {method}/{reduce}: {lines[:3]}")
        spectral_density_records(torch, card, ctx)

        rows, gold = wic_rows(np.random.default_rng(16), corpus, 512)
        with open(os.path.join(tmp, "wic.tsv"), "w") as f:
            f.writelines(rows)
        with open(os.path.join(tmp, "gold.txt"), "w") as f:
            f.writelines(gold)
        dt, out = cli(torch, ["train-wic", "--data", os.path.join(tmp, "wic.tsv"), "--gold",
                              os.path.join(tmp, "gold.txt"), "--save-path",
                              os.path.join(tmp, "wic")] + dev, card)
        log(f"train-wic: 512 rows in {dt:.2f} s, best loss {out['best']:.5f}, WiC accuracy "
            f"{out['wic']['accuracy']:.4f} (threshold {out['wic'].get('threshold')}) [{card}]")
        if not np.isfinite(out["best"]):
            raise AssertionError(f"train-wic: {out}")
    k2 = cosine_topk_cuda.launches
    log(f"phase 12: {time.time() - t0:.1f} s; K2 launches {k2}")
    if k2 == 0:
        raise AssertionError("phase 12 did not run K2")
    records["k2_launches"] = k2
    return records


# ---------------------------------------------------------------------------
# Phase 13: MoE and Performer
# ---------------------------------------------------------------------------

MOE_STAGES = ("ts.moe.router", "ts.moe.dispatch", "ts.moe.experts", "ts.moe.combine")
# Performer (FAVOR+, m = head_dim) against the exact path (K5, window 0) on
# the same roberta-base-long weights, one batch of 8 documents at 4096:
# last_hidden_state on valid rows, mean and max |Δ|; the first H100 reading
# is 2.107e-2 and 0.164, the max limit 2.5x it, the mean limit 2.37x it, so
# that the control, the next document's exact rows (mean |Δ| 0.524), lies
# 10x the mean limit away. (The unit embeddings cannot carry such a gate:
# with random weights distinct documents' embeddings differ about as much
# as the two paths' do, 1.0e-3 against 6.1e-4 mean |Δ|.)
PERFORMER_MEAN, PERFORMER_MAX = 5e-2, 0.41
# the card against the CPU, a 2-layer Performer cut at 2 x 4096, f32, one matrix
PERFORMER_CARD_CPU = 1e-4


# MoE IVF requests. A query encoded alone routes otherwise than its document
# did in the corpus's batches (the reference's capacity rule), so some
# single queries land in another cluster; self-retrieval is gated among the
# probed ones, and two bounds keep the rest in view: at least
# MOE_SINGLE_PROBED_MIN of the 20 single queries must have their own slab
# probed (five H100 readings: 15), and the IVF answers of the single
# queries must hold MOE_SINGLE_RECALL_MIN recall@10 against an exact top-10
# over the same 120,000 vectors on the same query vectors (three H100
# readings: 0.5150-0.5250; the serving args probe few of 512 clusters, and
# random weights spread a query's exact neighbours over many). Each floor leaves
# room for about three more single queries sent to another slab.
MOE_SINGLE_PROBED_MIN = 12
MOE_SINGLE_RECALL_MIN = 0.40


def ivf_against_exact(torch, requests, k=10):
    """Each IVF request's answers against an exact top-k over the same store
    on the same query vectors (the pipeline's own encode, f32 products) →
    {request size: [ids shared, ids asked, queries, exact self-hits]}; an
    exact self-hit is the query's own document in the exact top k at score
    ≥ 0.99, as ``serve_requests`` counts it."""
    out = {}
    for pipe, _, size, texts, req, _ in requests:
        if pipe._id_remap is not None:
            raise AssertionError("ivf_against_exact needs store rows in corpus order")
        q = pipe.encoder.encode(texts, batch_size=pipe.batch_size, device_output=True)
        s, i = (q.float() @ pipe.store.view.float().T).topk(k, dim=1)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        rec = out.setdefault(size, [0, 0, 0, 0])
        for row, es, ei, j in zip(pipe(texts, max_num_results=k), s, i, req):
            rec[0] += len({d for _, _, d in row} & set(ei.tolist()))
            rec[1] += k
            rec[2] += 1
            rec[3] += any(d == j and sc >= 0.99 for sc, d in zip(es, ei))
    return out


class MoeDrops:
    """Within the block, each ``encoder_forward`` that ``SentenceEncoder``
    runs adds its dropped fraction, weighted by its valid tokens; ``mean()``
    → their mean (it fails where no MoE forward was seen)."""

    def __enter__(self):
        import text_similarity_tpu_torch.models.sentence_encoder as se

        self.module, self.real, self.seen = se, se.encoder_forward, []

        def counted(params, ids, mask, *args, **kw):
            out = self.real(params, ids, mask, *args, **kw)
            if out.moe_drop is not None:
                n = mask.sum()
                self.seen.append((out.moe_drop * n, n))
            return out

        se.encoder_forward = counted
        return self

    def __exit__(self, *exc):
        self.module.encoder_forward = self.real

    def mean(self) -> float:
        if not self.seen:
            raise AssertionError("no MoE forward went through SentenceEncoder")
        return float(sum(d for d, _ in self.seen) / sum(n for _, n in self.seen))


def moe_pipeline_records(torch, card, ctx, enc):
    """The MoE encoder behind phase 4's two pipelines (120,000 documents on
    IVF, 2,000 by brute force) under phase 4's self-retrieval gate; K1 and
    K2 at the requests' shapes against their plain versions."""
    from text_similarity_tpu_torch.data import BUCKETS
    from text_similarity_tpu_torch.index.ivf import ivf_scan_cuda
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda
    from text_similarity_tpu_torch.pipelines import SemanticSearchPipeline
    from text_similarity_tpu_torch.pipelines.search import _pad_pow2

    corpus = ctx["corpus"]
    route = "packed" if enc.use_packed(enc._tokenize_rows(corpus[:20_000], 256), 128,
                                       BUCKETS) else "bucketed"
    pipes = {}
    for label, docs in (("ivf", corpus), ("brute", corpus[:2000])):
        with MoeDrops() as drops:
            torch.cuda.synchronize()
            t = time.time()
            pipes[label] = SemanticSearchPipeline(enc, corpus=docs, device="cuda")
            torch.cuda.synchronize()
            dt = time.time() - t
        log(f"MoE encode of {len(docs)} documents [{card}]: {dt:.2f} s = {len(docs) / dt:.0f} "
            f"sentences/s (minilm-l6 E 8 top-2 cf 1.25 bf16, packed='auto': {route}); "
            f"moe_drop {drops.mean():.5f}")
    big, small = pipes["ivf"], pipes["brute"]
    t = time.time()
    big._build_ivf()
    torch.cuda.synchronize()
    log(f"MoE IVF build over 120000 docs: {time.time() - t:.2f} s, "
        f"Mc={big.ivf.data_padded.shape[1]}, C={big.ivf.num_base_clusters}")
    big(corpus[:1], 10)
    small(corpus[:1], 10)
    rng = np.random.default_rng(13)
    results, requests = {}, []
    k1, k2 = ivf_scan_cuda.launches, cosine_topk_cuda.launches
    with MoeDrops() as drops:
        serve_requests(torch, big, "MoE ivf pipeline (120000 docs)", len(corpus),
                       [1] * 20 + [5, 64], rng, results, requests)
        serve_requests(torch, small, "MoE brute pipeline (2000 docs)", 2000, [1, 5, 64],
                       rng, results, requests)
    k1, k2 = ivf_scan_cuda.launches - k1, cosine_topk_cuda.launches - k2
    log(f"MoE requests: moe_drop of the queries' encodes {drops.mean():.5f}; K1 launches {k1}, "
        f"K2 launches {k2}")
    gate_requests(torch, results, requests, card, probed_only=True)
    single_probed = results[("MoE ivf pipeline (120000 docs)", 1)][2]
    exact = ivf_against_exact(torch, requests)
    for size, (shared, asked, n, self_hits) in sorted(exact.items()):
        log(f"MoE ivf pipeline, requests of {size}: recall@10 against an exact top-10 over the "
            f"same 120000 vectors on the same query vectors {shared / asked:.4f}; the exact "
            f"top-10 finds {self_hits}/{n} queries themselves at score >= 0.99 [{card}]")
    single_recall = exact[1][0] / exact[1][1]
    log(f"MoE ivf single queries: own slab probed for {single_probed}/20 (floor "
        f"{MOE_SINGLE_PROBED_MIN}), recall@10 against exact {single_recall:.4f} (floor "
        f"{MOE_SINGLE_RECALL_MIN})")
    if single_probed < MOE_SINGLE_PROBED_MIN or single_recall < MOE_SINGLE_RECALL_MIN:
        raise AssertionError(f"MoE ivf single queries: {single_probed}/20 probed, recall@10 "
                             f"against exact {single_recall:.4f}, below their floors")
    if k1 == 0 or k2 == 0:
        raise AssertionError(f"the MoE pipelines did not run K1 ({k1}) and K2 ({k2})")
    # the route gap: each of 64 documents encoded alone (a query's batch)
    # against its vector from the corpus's batches; the corpus route again
    picks = rng.choice(2000, 64, replace=False)
    alone = torch.cat([enc.encode([corpus[j]], device_output=True) for j in picks])
    cos = (alone * small.store.view[torch.as_tensor(picks, device=alone.device)]).sum(dim=1)
    again = enc.encode(corpus[:2000], device_output=True)
    same = float((again - small.store.view[:2000]).abs().max())
    log(f"MoE route gap [{card}]: 64 documents encoded alone against their corpus vectors: min "
        f"cosine {float(cos.min()):.6f}, mean {float(cos.mean()):.6f}, below 0.99: "
        f"{int((cos < 0.99).sum())}; the 2000-document encode repeated: max|Δ| {same:.2e}")
    if same > 1e-6:
        raise AssertionError(f"the MoE encode is not deterministic (max|Δ| {same:.2e})")
    q64 = [corpus[j] for j in picks]
    qe = _pad_pow2(enc.encode(q64, device_output=True))
    k2_held(torch, qe, small.store.view.contiguous(), (10, 20), "the MoE brute pipeline's "
            "64-query request", card)
    scan_at_requests(torch, big.ivf, lambda x: enc.encode(x, device_output=True), q64, 10,
                     "K1 (MoE encoder)", card)
    return small


def moe_records(torch, card, ctx):
    """minilm-l6 at full width with 8 experts (top-2, capacity factor 1.25;
    the drive's arch), random weights, bf16: the pipelines, the int8
    encoder, a profiled forward, ``train-sts --experts 8``, 30 steps, the
    router-skew drive."""
    import contextlib
    import io
    import tempfile

    from text_similarity_tpu_torch.core.config import ARCH_PRESETS, TrainConfig
    from text_similarity_tpu_torch.data.pairs import build_pair_batches
    from text_similarity_tpu_torch.drives import moe_router_skew
    from text_similarity_tpu_torch.models import SentenceEncoder, init_params
    from text_similarity_tpu_torch.train import (
        init_train_state, make_bi_encoder_train_step, make_optimizer,
    )

    corpus, tok = ctx["corpus"], ctx["tok"]
    arch = ARCH_PRESETS["minilm-l6"].replace(vocab_size=tok.vocab_size, num_experts=8,
                                             expert_top_k=2, expert_capacity_factor=1.25)
    params = init_params(arch, torch.Generator().manual_seed(0))
    enc = SentenceEncoder(params, arch, tokenizer=tok, device="cuda")
    small = moe_pipeline_records(torch, card, ctx, enc)

    enc8 = SentenceEncoder(params, arch, tokenizer=tok, device="cuda").to_int8()
    router = enc8.params["layers"]["mlp"]["router"]["w"]
    experts = enc8.params["layers"]["mlp"]["in"]["w"]
    torch.cuda.synchronize()
    t = time.time()
    e8 = enc8.encode(corpus[:2000], device_output=True)
    torch.cuda.synchronize()
    dt = time.time() - t
    cos = (e8 * small.store.view[:2000]).sum(dim=1)
    log(f"MoE int8 encoder [{card}]: 2000 documents in {dt:.2f} s = {2000 / dt:.0f} sentences/s; "
        f"unit embeddings against the bf16 encoder's: min cosine {float(cos.min()):.6f}, mean "
        f"{float(cos.mean()):.6f}; router {router.dtype}, experts {experts['q'].dtype}")
    if (not isinstance(router, torch.Tensor) or router.dtype != torch.float32
            or experts["q"].dtype != torch.int8 or not bool(torch.isfinite(e8).all())):
        raise AssertionError("to_int8 on the MoE encoder: the router must stay f32, the experts "
                             "int8, the embeddings finite")

    ids, mask = tok.encode_batch(corpus[:256], 128)
    split = profile_split(torch, "one MoE minilm-l6 forward (256 x 128, bf16)",
                          lambda: enc.embed_tokens(ids, mask), card, ranges=MOE_STAGES)
    if split is None:
        log("MoE forward split by stage: not measured")

    build = os.path.join(REPO, "text_similarity_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    rng = np.random.default_rng(14)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        picks = rng.choice(len(corpus), 1024, replace=False)
        with open(os.path.join(tmp, "sts.tsv"), "w") as f:
            f.writelines(f"{corpus[i]}\t{corpus[j]}\t{rng.uniform(0, 5):.2f}\n"
                         for i, j in zip(picks[:512], picks[512:]))
        dt, out = cli(torch, ["train-sts", "--data", os.path.join(tmp, "sts.tsv"), "--no-eval",
                              "--experts", "8", "--expert-top-k", "2", "--arch", "minilm-l6",
                              "--batch-size", "32", "--save-path", os.path.join(tmp, "run"),
                              "--device", "cuda"], card)
        with open(os.path.join(tmp, "run", "results.jsonl")) as f:
            train = [json.loads(line)["train"] for line in f][-1]
        log(f"train-sts --experts 8 [{card}]: 512 pairs in {dt:.2f} s = {512 / dt:.1f} pairs/s "
            f"over the command; epoch loss {train['loss']:.6f}, moe_aux {train['moe_aux']:.6f}, "
            f"moe_drop {train['moe_drop']:.6f}")
        if not all(np.isfinite(train[k]) for k in ("loss", "moe_aux", "moe_drop")):
            raise AssertionError(f"train-sts --experts 8: {train}")

        pairs = [(corpus[i], corpus[j]) for i, j in zip(picks[:32], picks[32:64])]
        batch = build_pair_batches(tok, pairs, rng.random(32).astype(np.float32),
                                   batch_size=32, max_len=128)[0]
        steps = 30
        tx = make_optimizer(TrainConfig(lr=1e-4), steps, params_example={"encoder": params})
        state = init_train_state({"encoder": params}, tx, device="cuda")
        step = make_bi_encoder_train_step(arch, tx, device="cuda")
        metrics = []
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(steps):
            state, m = step(state, batch)
            metrics.append(m)
        torch.cuda.synchronize()
        dt = time.time() - t
        first, last = (float(metrics[i]["loss"]) for i in (0, -1))
        log(f"MoE bi-encoder [{card}]: 32 pairs x {steps} steps in {dt:.2f} s; loss first "
            f"{first:.6f}, last {last:.6f}; moe_aux {float(metrics[-1]['moe_aux']):.5f}, "
            f"moe_drop {float(metrics[-1]['moe_drop']):.5f} at the last step")
        if not last < first:
            raise AssertionError(f"the MoE bi-encoder's loss did not fall: {first} -> {last}")

        rows = {}
        for mode, argv in (("train", ["--train", "--steps", "100"]), ("sweep", ["--sweep"])):
            buf = io.StringIO()
            t = time.time()
            with contextlib.redirect_stdout(buf):
                rows[mode] = moe_router_skew.main(argv + ["--ckpt", os.path.join(tmp, "skew"),
                                                          "--device", "cuda"])
            log(f"router-skew drive --{mode} [{card}]: {time.time() - t:.1f} s")
        tr = rows["train"]
        log(f"  --train: {tr['steps']} MLM steps in {tr['train_seconds']:.1f} s, final loss "
            f"{tr['final_loss']:.4f}; drop at {tr['eval_shape']}:")
        for mode in ("train", "sweep"):
            for a, b in zip(rows[mode]["trained"], rows[mode]["random"]):
                rate = (f", sentences/s trained {a['sent_per_s']:.0f} (windows "
                        f"{', '.join(f'{w:.0f}' for w in a['sent_per_s_windows'])}), random "
                        f"{b['sent_per_s']:.0f}" if mode == "sweep" else "")
                log(f"  --{mode} top_k {a['top_k']} cf {a['cf']}: moe_drop trained "
                    f"{a['moe_drop']:.5f}, random {b['moe_drop']:.5f}; moe_aux trained "
                    f"{a['moe_aux']:.4f}, random {b['moe_aux']:.4f}{rate}")
        every = [r for m in rows.values() for r in m["trained"] + m["random"]]
        if len(every) != 4 * len(moe_router_skew.SWEEP) or not all(
                0 <= r["moe_drop"] <= 1 and np.isfinite(r["moe_aux"]) for r in every):
            raise AssertionError("the router-skew drive's tables are incomplete or out of range")


def performer_records(torch, card, ctx):
    """roberta-base at 4098 positions (phase 6's weights) with Performer
    attention (m = head_dim), bf16, against the same weights on the exact
    path (K5, window 0); the card against the CPU; causal FAVOR+ against the
    exact causal attention; 8 steps with a redraw every 4; the ``"auto"``
    encode route."""
    from text_similarity_tpu_torch.core.config import TrainConfig
    from text_similarity_tpu_torch.core.precision import FP32_PRECISION
    from text_similarity_tpu_torch.data.pairs import build_pair_batches
    from text_similarity_tpu_torch.index import BruteForceIndex, EmbeddingStore
    from text_similarity_tpu_torch.models import SentenceEncoder, encoder_forward
    from text_similarity_tpu_torch.ops import performer
    from text_similarity_tpu_torch.ops.attention import (
        attention_reference, flash_attention_cuda, multi_head_attention, packed_attention_cuda,
    )
    from text_similarity_tpu_torch.train import (
        init_train_state, make_bi_encoder_train_step, make_optimizer,
    )

    tok, corpus = ctx["tok"], ctx["corpus"]
    docs = long_documents(tok, corpus[:24_000], np.random.default_rng(6), 112, 16)
    params, arch = long_arch_params(torch)
    exact_arch = arch.replace(attention_window=0, window_global_cls=False)
    perf_arch = exact_arch.replace(attention_type="performer")
    kw = dict(max_len=4096, buckets=LONG_BUCKETS, batch_size=8, packed=False)
    encs = {"performer": SentenceEncoder(params, perf_arch, tokenizer=tok, device="cuda"),
            "exact": SentenceEncoder(params, exact_arch, tokenizer=tok, device="cuda")}
    n_4096 = sum(bucket == 4096 for bucket, _ in bucket_batches(encs["exact"], docs, 8))
    emb, k5 = {}, {}
    for name, enc in encs.items():
        enc.encode(docs[:8], **kw)
        before = (flash_attention_cuda.launches, packed_attention_cuda.launches)
        torch.cuda.synchronize()
        t = time.time()
        emb[name] = enc.encode(docs, device_output=True, **kw)
        torch.cuda.synchronize()
        dt = time.time() - t
        k5[name] = (flash_attention_cuda.launches - before[0],
                    packed_attention_cuda.launches - before[1])
        log(f"{name} roberta-base-long encode [{card}]: {len(docs)} documents in {dt:.2f} s = "
            f"{len(docs) / dt:.1f} docs/s; K5 launches {k5[name][0]}, K7 {k5[name][1]}")
    if k5["performer"] != (0, 0) or k5["exact"][0] != 12 * n_4096 or n_4096 == 0:
        raise AssertionError(f"K5 / K7 launches {k5}: the Performer path must run neither, the "
                             f"exact path K5 in 12 layers x {n_4096} batches")
    ep, ex = emb["performer"], emb["exact"]
    diff = (ep - ex).abs()
    control = float((ep - ex.roll(1, dims=0)).abs().mean())
    cos = (ep * ex).sum(dim=1)
    log(f"Performer against the exact path (K5, window 0), unit embeddings of {len(docs)} "
        f"documents: mean|Δ| {float(diff.mean()):.4e}, max|Δ| {float(diff.max()):.4e}, min "
        f"cosine {float(cos.min()):.6f}, mean {float(cos.mean()):.6f}; control, the next "
        f"document's: mean|Δ| {control:.4e} [{card}]")
    if not bool(torch.isfinite(ep).all()):
        raise AssertionError("the Performer embeddings are not finite")
    rows = encs["exact"]._tokenize_rows(docs, 4096)
    long_idx = [j for j in range(len(docs)) if len(rows[j]) > 2048][:8]
    mean, worst, control, min_cos = path_agreement(
        torch, encs["performer"], [docs[j] for j in long_idx],
        paths=((encs["performer"], "auto"), (encs["exact"], "auto")))
    ok = mean <= PERFORMER_MEAN and worst <= PERFORMER_MAX and control >= 10 * PERFORMER_MEAN
    log(f"Performer against the exact path, last_hidden_state of 8 documents at 4096 on valid "
        f"rows: mean|Δ| {mean:.4e}, max|Δ| {worst:.4e} (limits {PERFORMER_MEAN:.1e}, "
        f"{PERFORMER_MAX:.1e}); control, the next document's rows: mean|Δ| {control:.4e}; "
        f"pooled min cosine {min_cos:.6f} -> {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError("the Performer states are not within their limits of the exact "
                             "path's, or the control does not separate them")

    store = EmbeddingStore(len(docs), ep.shape[1], device="cuda")
    store.add(ep)
    picks = np.random.default_rng(15).choice(len(docs), 16, replace=False)
    q = encs["performer"].encode([docs[j] for j in picks], device_output=True, **kw)
    scores, ids = BruteForceIndex(store).query(q, k=10)
    hits = sum(any(i == j and s >= 0.99 for s, i in zip(srow, irow))
               for j, srow, irow in zip(picks, scores, ids))
    k2_held(torch, q, store.view.contiguous(), (10,), "the Performer self-retrieval", card)
    log(f"Performer self-retrieval: {hits}/16 documents in their top 10 at score >= 0.99")
    if hits < 0.95 * 16:
        raise AssertionError(f"Performer self-retrieval {hits}/16 below 95%")

    p2, a2 = long_arch_params(torch, layers=2)
    a2 = a2.replace(attention_window=0, window_global_cls=False, attention_type="performer")
    ids_np = np.full((2, 4096), tok.pad_id, np.int32)
    mask_np = np.zeros((2, 4096), np.int32)
    for r, row in enumerate(rows[:2]):
        ids_np[r, :len(row)], mask_np[r, :len(row)] = row, 1

    def tree_to(tree, dev):
        return {k: tree_to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    outs = {}
    for dev in ("cuda", "cpu"):
        with torch.no_grad():
            outs[dev] = encoder_forward(tree_to(p2, dev), torch.from_numpy(ids_np).to(dev),
                                        torch.from_numpy(mask_np).to(dev), arch=a2,
                                        precision=FP32_PRECISION).last_hidden_state.cpu()
    gap = float((outs["cuda"] - outs["cpu"]).abs().max())
    log(f"Performer on the card against the CPU (2 layers, 2 x 4096, f32, one matrix): max|Δ| "
        f"{gap:.3e} (limit {PERFORMER_CARD_CPU:.0e}) [{card}]")
    if not gap <= PERFORMER_CARD_CPU:
        raise AssertionError(f"Performer: the card and the CPU differ by {gap:.3e}")

    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (0.5 * torch.randn((8, 4096, 12, 64), generator=g, device="cuda")
               for _ in range(3))
    proj = performer.projection(perf_arch, device="cuda")
    causal = performer.performer_attention_causal(q, k, v, proj)
    exact = attention_reference(q, k, v, causal=True)
    mix = multi_head_attention(q, k, v, impl="performer", performer_proj=proj, causal=True,
                               performer_local_heads=4, performer_local_window=64)
    band = attention_reference(q[:, :, :4], k[:, :, :4], v[:, :, :4], window=64,
                               global_cls=False, causal=True)
    fav_ms = time_ms(torch, lambda: performer.performer_attention_causal(q, k, v, proj), iters=3)
    ref_ms = time_ms(torch, lambda: attention_reference(q, k, v, causal=True), iters=2, warmup=1)
    local_gap = float((mix[:, :, :4] - band).abs().max())
    log(f"causal FAVOR+ at 8 x 4096 x 12 x 64 (f32, m 64) against exact causal attention: "
        f"max|Δ| {float((causal - exact).abs().max()):.4e}, mean|Δ| "
        f"{float((causal - exact).abs().mean()):.4e}; {fav_ms:.2f} ms against {ref_ms:.2f} ms; "
        f"4 local heads (band 64) + 8 linear: local heads against the banded causal reference "
        f"max|Δ| {local_gap:.2e}, linear heads against exact max|Δ| "
        f"{float((mix[:, :, 4:] - exact[:, :, 4:]).abs().max()):.4e} [{card}]")
    if not (bool(torch.isfinite(causal).all()) and bool(torch.isfinite(mix).all())
            and local_gap <= 1e-5):
        raise AssertionError("causal FAVOR+: non-finite output, or the local heads are not the "
                             "banded causal attention")
    del q, k, v, causal, exact, mix, band

    t_arch = perf_arch.replace(performer_redraw_every=4)
    rng = np.random.default_rng(16)
    picks = rng.choice(len(corpus), 32, replace=False)
    batch = build_pair_batches(tok, [(corpus[i], corpus[j]) for i, j in zip(picks[:16],
                                                                          picks[16:])],
                               rng.random(16).astype(np.float32), batch_size=16, max_len=128)[0]
    tx = make_optimizer(TrainConfig(lr=1e-5), 8, params_example={"encoder": params})
    state = init_train_state({"encoder": params}, tx, device="cuda")
    step = make_bi_encoder_train_step(t_arch, tx, device="cuda")
    performer.draw_projection.cache_clear()
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    draws = performer.draw_projection.cache_info().misses
    mats = [performer.projection(t_arch, s, "cuda") for s in range(8)]
    same = [bool(torch.equal(mats[s], mats[s - 1])) for s in range(1, 8)]
    log(f"Performer bi-encoder, redraw every 4 [{card}]: 8 steps, losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; matrices drawn in the steps {draws}; "
        f"step s equal to step s - 1: {same}")
    if (not all(np.isfinite(losses)) or draws != 2
            or same != [True, True, True, False, True, True, True]):
        raise AssertionError("the Performer redraw: losses not finite, or the matrix did not "
                             "change at the epoch boundary only")

    mixed = corpus[:64] + docs[:2]
    enc = encs["performer"]
    routed = enc.use_packed(enc._tokenize_rows(mixed, 4096), 8, LONG_BUCKETS)
    out = enc.encode(mixed, max_len=4096, buckets=LONG_BUCKETS, batch_size=8)
    log(f"Performer encode(packed='auto') of 64 sentences and 2 long documents: packs "
        f"{routed}, {tuple(out.shape)} finite {bool(np.isfinite(out).all())}")
    if routed or not np.isfinite(out).all():
        raise AssertionError("a Performer model packed or failed under packed='auto'")


def phase_moe_performer(torch, card, ctx):
    """Phase 13: the MoE expert FFN and Performer attention in the encoder."""
    t0 = time.time()
    moe_records(torch, card, ctx)
    performer_records(torch, card, ctx)
    log(f"phase 13: {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 14: the distributed serving path (the mesh, the sharded indexes,
# ShardedSearchPipeline behind SearchServer, the data-parallel and the
# context-parallel encode), every shard or position on the one card
# ---------------------------------------------------------------------------

SHARDS = 4
# four shards or positions share the one card here: no rate below is a
# multi-card number
ONE_CARD = f"{SHARDS} shards on one card"
# the data-parallel encode (rows split over 4 positions) against the
# mesh-less encode, minilm-l6 bf16: min cosine of the unit embeddings
DP_MIN_COS = 0.9999
# the context-parallel forward (ring, Ulysses) on the card against the CPU,
# a 2-layer cut of roberta-base at 4096, f32: max |Δ| of last_hidden_state
CP_CARD_CPU = 1e-5
# encode_long (ring, Ulysses; seq 4) against encode (K5) of the same 8
# documents, roberta-base bf16: min cosine of the unit embeddings (1 - cos
# read 7e-7 to 1.5e-6); the control, each encode_long vector against the
# next document's encode vector, must fall below it (1 - cos read 2.2e-4:
# random weights barely spread long documents)
LONG_MIN_COS = 0.99999


def host_merge(parts, k):
    """Per-shard (scores, ids) numpy lists → the top k of each row by
    (score desc, id asc), merged on the host."""
    s = np.concatenate([p[0] for p in parts], axis=1)
    i = np.concatenate([p[1] for p in parts], axis=1)
    order = np.lexsort((i, -s), axis=1)[:, :k]
    return np.take_along_axis(s, order, 1), np.take_along_axis(i, order, 1)


def sharded_k1_held(torch, sidx, queries, k, label, card, timed=False):
    """Each shard's K1 at the shapes ``ShardedIVFIndex.shard_query`` gives
    it (``kernel_plan``: query block, probe union, merge mode) against its
    plain version, as ``check_pair`` holds it, the route the kernel library
    took printed; these launches leave K1's counters as they were. → the
    shards' (scores, ids) in query order (numpy) and how many ran on the
    wgmma tile."""
    from types import SimpleNamespace

    from text_similarity_tpu_torch.index.ivf import (
        _plan_probes, ivf_scan_cuda, ivf_scan_reference,
    )
    from text_similarity_tpu_torch.ops.topk import l2_normalize

    counts = ivf_scan_cuda.launches, ivf_scan_cuda.launches_tile
    q = l2_normalize(torch.as_tensor(queries).float())
    block_q, union, w, slots = sidx.kernel_plan(q.shape[0], k, sidx.num_probes)
    parts, on_tile = [], 0
    for si, (data, ids) in enumerate(zip(sidx.data_padded, sidx.ids_padded)):
        qs, probes, order = _plan_probes(q.to(data.device), sidx.centroids.to(data.device),
                                         sidx.num_base_clusters, data.shape[0], block_q, union)
        args = (qs, probes, data, ids, k, block_q, w, slots)
        path, plan = scan_path(SimpleNamespace(data_padded=data, ids_padded=ids), qs, probes,
                               block_q, k, w, slots)
        tiles = ivf_scan_cuda.launches_tile
        ks, ki = ivf_scan_cuda(*args)
        rs, ri = ivf_scan_reference(*args)
        on_tile += ivf_scan_cuda.launches_tile - tiles
        ms = time_ms(torch, lambda: ivf_scan_cuda(*args), iters=5, warmup=1) if timed else None
        check_pair(f"K1 {label}, shard {si} (B {qs.shape[0]}, block_q {block_q}, U "
                   f"{probes.shape[1]}, Mc {data.shape[1]}, k {k}, "
                   f"{f'deferred w={w} S={slots}' if w else 'exact'} merge, on the {path})",
                   ks, ki, rs, ri, card, ms=ms, k1_ms=ms)
        inv = torch.argsort(order)
        parts.append((ks[inv].cpu().numpy(), ki[inv].cpu().numpy()))
    ivf_scan_cuda.launches, ivf_scan_cuda.launches_tile = counts
    return parts, on_tile


def sharded_ivf_records(torch, card, corpus, queries, exact, ivf):
    """Phase 3's 1M × 384 corpus over 4 index shards at bench.py's index
    settings (C 2048, 56 probes, 8 k-means iterations), bf16 slabs: recall
    and QPS beside the unsharded index, K1 four launches a call, each
    shard's K1 against its plain version at the shard's shapes, the merge
    against a host merge."""
    from text_similarity_tpu_torch.core.config import IndexConfig
    from text_similarity_tpu_torch.core.mesh import make_mesh
    from text_similarity_tpu_torch.index.ivf import ivf_scan_cuda
    from text_similarity_tpu_torch.index.sharded import ShardedIVFIndex, _unpack_results

    mesh = make_mesh(data=1, index=SHARDS, devices=["cuda:0"] * SHARDS)
    cfg = IndexConfig(num_clusters=2048, num_probes=56, kmeans_iters=8)
    torch.cuda.synchronize()
    t = time.time()
    sidx = ShardedIVFIndex.build(mesh, corpus, cfg, data_dtype=torch.bfloat16,
                                 generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.time() - t
    c_tot, mc = sidx.data_padded[0].shape[:2]
    n_base = sidx.num_base_clusters
    log(f"sharded IVF build [{card}, {ONE_CARD}]: {build_s:.2f} s for {corpus.shape[0]}x"
        f"{corpus.shape[1]}, C={n_base} global clusters, per shard Mc={mc}, "
        f"{c_tot - n_base} overflow slabs")

    sidx.query(queries[:64], k=10)          # warm outside the counted window
    before, tiles = ivf_scan_cuda.launches, ivf_scan_cuda.launches_tile
    _, got = sidx.query(queries, k=10)
    k1 = ivf_scan_cuda.launches - before
    on_tile = ivf_scan_cuda.launches_tile - tiles
    recall = overlap(got, exact)
    _, base = ivf.query(queries, k=10, block_q=64, union_factor=1, approx_width=2048)
    base_recall = overlap(base.cpu().numpy(), exact)
    t_s = time_ms(torch, lambda: sidx.query_packed(queries, k=10), iters=3, warmup=1)
    t_u = time_ms(torch, lambda: ivf.query(queries, k=10, block_q=64, union_factor=1,
                                           approx_width=2048), iters=3, warmup=1)
    n_q = queries.shape[0]
    log(f"sharded IVF recall@10 vs exact: {recall:.4f} (gate 0.95; the unsharded index "
        f"{base_recall:.4f}); {n_q} queries @k=10 {t_s:.2f} ms = {n_q / t_s * 1e3:.0f} QPS "
        f"(unsharded {t_u:.2f} ms = {n_q / t_u * 1e3:.0f} QPS) [{card}, {ONE_CARD}]; K1 "
        f"launches a call {k1} ({on_tile} on the wgmma tile)")
    if recall < 0.95:
        raise AssertionError(f"sharded IVF recall@10 {recall:.4f} below 0.95")
    if k1 != SHARDS:
        raise AssertionError(f"K1 launched {k1} times in one sharded query, expected {SHARDS}")

    # each shard's K1 at its shapes against the plain version, then the merge
    parts, _ = sharded_k1_held(torch, sidx, queries, 10, "at the bench shape", card, timed=True)
    ms_, mi_ = host_merge(parts, 10)
    packed, k_eff = sidx.query_packed(queries, k=10)
    ds, di = _unpack_results(packed, k_eff, n_q)
    same = np.array_equal(di, mi_) and np.array_equal(ds, ms_)
    log(f"sharded IVF merge against a host merge of the four shards' K1 answers: "
        f"{'bit-equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("the sharded IVF merge differs from the host merge")
    del sidx


def sharded_brute_records(torch, card, ctx):
    """Phase 4's 120,000 minilm-l6 corpus vectors over 4 index shards: K2
    four launches a call, each shard's K2 against its plain version, the
    answer against ``BruteForceIndex`` where the f32 scores are separated."""
    from text_similarity_tpu_torch.core.mesh import make_mesh
    from text_similarity_tpu_torch.index import BruteForceIndex
    from text_similarity_tpu_torch.index.sharded import ShardedBruteForceIndex
    from text_similarity_tpu_torch.ops.topk import (
        cosine_topk_cuda, cosine_topk_reference, l2_normalize,
    )

    emb = ctx["big"].store.view
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = torch.linspace(0, emb.shape[0] - 1, 256, device="cuda").long()
    q = l2_normalize(emb[rows] + 0.05 * torch.randn((256, emb.shape[1]), device="cuda",
                                                    generator=gen))
    mesh = make_mesh(data=1, index=SHARDS, devices=["cuda:0"] * SHARDS)
    sbf = ShardedBruteForceIndex.build(mesh, emb)
    sbf.query(q[:8], k=10)
    before = cosine_topk_cuda.launches
    s, i = sbf.query(q, k=11)
    k2 = cosine_topk_cuda.launches - before
    rs, ri = BruteForceIndex.from_embeddings(emb).query(q, k=11)
    ok = separated_ids_equal(i[:, :10], ri[:, :10], rs[:, :10], next_scores=rs[:, 10])
    err = float(np.abs(s - rs).max())
    t_s = host_ms(torch, lambda: sbf.query(q, k=10))
    single = BruteForceIndex.from_embeddings(emb)
    t_u = host_ms(torch, lambda: single.query(q, k=10))
    log(f"sharded brute force ({emb.shape[0]} x {emb.shape[1]} f32, {sbf.shard_rows} rows a "
        f"shard): K2 launches a call {k2}; ids equal to BruteForceIndex's where separated: {ok}, "
        f"max|Δscore| {err:.2e}; 256 queries @k=10 to the host {t_s:.3f} ms (BruteForceIndex "
        f"{t_u:.3f} ms) [{card}, {ONE_CARD}]")
    qf = l2_normalize(q.float())
    for si, shard in enumerate(sbf.shards):
        ks, ki = cosine_topk_cuda(qf, shard, 10)
        rs_, ri_ = cosine_topk_reference(qf, shard, 10)
        check_pair(f"K2 shard {si} (Q 256, N {shard.shape[0]}, k 10)", ks, ki, rs_, ri_, card)
    if k2 != SHARDS:
        raise AssertionError(f"K2 launched {k2} times in one sharded query, expected {SHARDS}")
    if not ok or err > 1e-5:
        raise AssertionError("the sharded brute-force answer differs from BruteForceIndex's")


def sharded_pipeline_records(torch, card, ctx):
    """The daemon over a ``ShardedSearchPipeline`` (minilm-l6, bf16, random
    weights; 4 index shards; the encode data-parallel over 4 positions):
    the counted window of this slice's path (K1, K2); → their launches."""
    import tempfile

    from text_similarity_tpu_torch.cli.main import build_parser, build_server
    from text_similarity_tpu_torch.core.mesh import make_mesh
    from text_similarity_tpu_torch.index.ivf import ivf_scan_cuda
    from text_similarity_tpu_torch.models import SentenceEncoder
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda
    from text_similarity_tpu_torch.pipelines import SearchServer, ShardedSearchPipeline

    corpus, tok, base = ctx["corpus"], ctx["tok"], ctx["enc"]
    docs = corpus[:20_000]
    devs = ["cuda:0"] * SHARDS
    enc = SentenceEncoder(base.params, base.arch, tokenizer=tok, precision=base.precision,
                          device="cuda", mesh=make_mesh(data=SHARDS, devices=devs))
    mesh = make_mesh(data=1, index=SHARDS, devices=devs)
    probe = corpus[-2000:]
    enc.encode(probe[:256])
    torch.cuda.synchronize()
    t = time.time()
    dp = enc.encode(probe)
    torch.cuda.synchronize()
    dp_s = time.time() - t
    t = time.time()
    alone = base.encode(probe)
    torch.cuda.synchronize()
    alone_s = time.time() - t
    cos = float((dp * alone).sum(axis=1).min())
    log(f"data-parallel encode (data={SHARDS}) against the mesh-less encode, 2,000 "
        f"sentences: min cosine {cos:.7f} (gate {DP_MIN_COS}); {len(probe) / dp_s:.0f} against "
        f"{len(probe) / alone_s:.0f} sentences/s [{card}, {ONE_CARD}]")
    if cos < DP_MIN_COS:
        raise AssertionError(f"data-parallel encode min cosine {cos:.7f} below {DP_MIN_COS}")

    # the counted window: serving on the sharded pipelines
    cosine_topk_cuda.launches = 0
    ivf_scan_cuda.launches = 0
    t = time.time()
    brute = ShardedSearchPipeline(enc, mesh, corpus=docs, use_ivf=False)
    ivf_pipe = ShardedSearchPipeline(enc, mesh, corpus=docs, use_ivf=True)
    torch.cuda.synchronize()
    log(f"two sharded pipelines over {len(docs)} documents (brute force; IVF "
        f"C={ivf_pipe.index.num_base_clusters}, Mc={ivf_pipe.index.data_padded[0].shape[1]}): "
        f"{time.time() - t:.1f} s, two data-parallel encodes and the builds")
    server = SearchServer(brute, port=0, batch_window=0.002)
    server.start_background()
    rng = np.random.default_rng(14)
    picks = [int(j) for j in rng.choice(len(docs), 96, replace=False)]
    try:
        health, _ = http_ok(server.port, "/health")
        if health != {"status": "ok", "size": len(docs), "ivf": False, "sharded": True}:
            raise AssertionError(f"/health of the sharded daemon: {health}")
        hits, ms = 0, []
        for j in picks[:32]:
            body, dt = http_ok(server.port, "/search", {"queries": [docs[j]], "k": 10})
            hits += any(r["id"] == j and r["score"] >= 0.99 for r in body["results"][0])
            ms.append(dt)
        body, dt64 = http_ok(server.port, "/search", {"queries": [docs[j] for j in picks[32:]],
                                                      "k": 10})
        hits64 = sum(any(r["id"] == j and r["score"] >= 0.99 for r in row)
                     for j, row in zip(picks[32:], body["results"]))
        gone = picks[:5]
        removed, _ = http_ok(server.port, "/remove", {"ids": gone})
        body, _ = http_ok(server.port, "/search", {"queries": [docs[j] for j in gone], "k": 10})
        back = sum(r["id"] in gone for row in body["results"] for r in row)
        log(f"sharded daemon (brute force) [{card}, {ONE_CARD}]: /health {health}; one-text "
            f"/search {hits}/32 find themselves (median {np.median(ms):.2f} ms); a 64-text "
            f"request {hits64}/64 ({dt64:.1f} ms); /remove of 5 -> {removed['removed']}, "
            f"{back} of them answered after")
    finally:
        server.shutdown()
    ivf_hits = 0
    for j in picks[:32]:
        ivf_hits += any(d == j and sc >= 0.99 for _, sc, d in ivf_pipe([docs[j]], 10)[0])
    ivf_pipe.remove_documents(picks[:5])
    ivf_back = sum(d in picks[:5] for row in ivf_pipe([docs[j] for j in picks[:5]], 10)
                   for _, _, d in row)
    launches = {"cosine_topk": cosine_topk_cuda.launches, "ivf_scan": ivf_scan_cuda.launches}
    log(f"sharded IVF pipeline: one-text requests {ivf_hits}/32 find themselves; after "
        f"removing 5, {ivf_back} of them answered; launches in the counted window {launches}")
    launches["cosine_topk_large"] = nearest_removed(torch, card, brute, docs[picks[40]])
    merged = sharded_requests_held(torch, card, enc, brute, ivf_pipe,
                                   {"one-text": [docs[picks[0]]],
                                    "64-text": [docs[j] for j in picks[32:]]})

    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        brute.save(os.path.join(tmp, "sp"))
        loaded = ShardedSearchPipeline.load(os.path.join(tmp, "sp"), enc, mesh)
        texts = [docs[j] for j in picks[32:48]]
        same = ([[(d, i) for d, _, i in r] for r in loaded(texts, 10)]
                == [[(d, i) for d, _, i in r] for r in brute(texts, 10)])
        base.save(os.path.join(tmp, "enc"))
        try:
            build_server(build_parser().parse_args(
                ["serve", "--model", os.path.join(tmp, "enc"), "--shards", "2", "--port", "0"]
            )).shutdown()
            refused = None
        except SystemExit as e:
            refused = str(e)
    log(f"sharded pipeline save -> load: the same answers to 16 requests: {same}")
    log(f"serve --shards 2 on this machine: {refused!r}")

    if hits < 0.95 * 32 or hits64 < 0.95 * 64 or ivf_hits < 0.95 * 32:
        raise AssertionError(f"sharded self-retrieval below 95%: {hits}/32, {hits64}/64, "
                             f"IVF {ivf_hits}/32")
    if removed["removed"] != 5 or back or ivf_back:
        raise AssertionError(f"removed documents came back: daemon {back}, IVF {ivf_back}")
    if not same:
        raise AssertionError("a loaded sharded pipeline answers otherwise")
    n_cards = torch.cuda.device_count()
    if n_cards < 2 and (refused is None or f"{n_cards} visible" not in refused):
        raise AssertionError(f"serve --shards 2 on {n_cards} card(s) did not refuse: {refused!r}")
    if launches["cosine_topk"] == 0 or launches["ivf_scan"] == 0:
        raise AssertionError(f"a kernel of the sharded path never launched: {launches}")
    if not merged:
        raise AssertionError("the sharded IVF pipeline's merge differs from the host merge")
    return launches


def nearest_removed(torch, card, brute, text):
    """The sharded brute-force pipeline with a query's 300 nearest
    documents removed: its k = 10 answer over-fetches past the tombstones
    (512 a shard, K2's large-k route) and must hold 10 live rows, none of
    the removed, equal to the host's top 10 of the live documents where the
    scores are separated. The window from the k = 300 answer to the k = 10
    one counted. → the large-k route's launches."""
    from text_similarity_tpu_torch.ops.topk import cosine_topk_large_cuda

    cosine_topk_large_cuda.launches = 0
    near = brute([text], max_num_results=300)[0]
    removed = [i for _, _, i in near]
    gone = brute.remove_documents(removed)
    t = time.time()
    row = brute([text], max_num_results=10)[0]
    ms = (time.time() - t) * 1e3
    launches = cosine_topk_large_cuda.launches
    emb = brute._emb
    q = np.asarray(brute.encoder.encode([text]), np.float32)[0]
    sc = emb @ q
    sc[sorted(brute._removed)] = -np.inf
    order = np.argsort(-sc, kind="stable")[:11]
    got_i = np.array([[i for _, _, i in row]])
    got_s = np.array([[s_ for _, s_, _ in row]])
    same = separated_ids_equal(got_i, order[None, :10], sc[order][None, :10],
                               next_scores=sc[order][None, 10])
    err = float(np.abs(got_s - sc[order][None, :10]).max())
    ok = (len(row) == 10 and gone == 300 and not set(got_i[0]) & set(removed) and same
          and err <= 1e-4 and launches > 0)
    log(f"sharded brute force with the query's 300 nearest removed: {len(row)} live rows, "
        f"removed ids among them {len(set(got_i[0]) & set(removed))}, equal to the host's top "
        f"10 of the live documents where separated {same} (max|Δscore| {err:.2e}); K2 large-k "
        f"launches from the k 300 answer to the k 10 one {launches}; the k 10 request "
        f"{ms:.1f} ms [{card}, {ONE_CARD}] -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the sharded brute-force pipeline's answer after removing the 300 "
                             "nearest documents is wrong")
    return launches


def sharded_requests_held(torch, card, enc, brute, ivf_pipe, requests):
    """K1 and K2 at the shapes the sharded pipelines gave them, after the
    removals: each request's texts encoded and padded as ``__call__`` does;
    each IVF shard's K1 at ``kernel_plan``'s blocks (16-query blocks, union
    factor 3 below 32 probes) and the merge against a host merge of their
    answers; each brute-force shard's K2 at the k before the removals and
    at the over-fetched k after them (``k + n_pad`` a shard). → whether
    every merge was bit-equal."""
    from text_similarity_tpu_torch.index.sharded import _unpack_results
    from text_similarity_tpu_torch.ops.topk import l2_normalize
    from text_similarity_tpu_torch.pipelines.search import _pad_pow2

    idx = brute.index
    fetch = 1 << (10 + len(brute._removed) - 1).bit_length()
    k_local = sorted({min(k + idx.n_pad, idx.shard_rows)
                      for k in (10, min(fetch, len(brute.corpus)))})
    merged, tiles, held = True, 0, 0
    for label, texts in requests.items():
        q = _pad_pow2(enc.encode(texts, device_output=True))
        parts, on_tile = sharded_k1_held(torch, ivf_pipe.index, q, 10,
                                         f"at a {label} request", card)
        tiles, held = tiles + on_tile, held + len(parts)
        packed, k_eff = ivf_pipe.index.query_packed(q, k=10)
        got = _unpack_results(packed, k_eff, q.shape[0])
        want = host_merge([(s_[:q.shape[0]], i_[:q.shape[0]]) for s_, i_ in parts], k_eff)
        same = np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        log(f"sharded IVF pipeline merge at a {label} request against a host merge of the "
            f"shards' K1 answers: {'bit-equal' if same else 'DIFFERENT'}")
        merged &= same
        for si, shard in enumerate(idx.shards):
            k2_held(torch, l2_normalize(q), shard, k_local,
                    f"a {label} request, brute-force shard {si}", card)
    log(f"K1 at the sharded pipeline's requests: {tiles} of {held} held launches on the "
        f"wgmma tile, the rest on the CUDA-core kernel [{card}, {ONE_CARD}]")
    return merged


def context_parallel_records(torch, card, ctx):
    """roberta-base at 4098 positions (phase 6's weights), window 0, bf16:
    8 documents of up to 4096 tokens through ``encode_long`` with seq 4,
    ring and Ulysses, against the single-device exact path (K5); the card
    against the CPU on a 2-layer cut, f32."""
    from text_similarity_tpu_torch.core.mesh import SEQ_AXIS, make_mesh, replicate
    from text_similarity_tpu_torch.core.precision import FP32_PRECISION
    from text_similarity_tpu_torch.models import SentenceEncoder, encoder_forward
    from text_similarity_tpu_torch.models.long_context import encoder_forward_cp
    from text_similarity_tpu_torch.ops.attention import flash_attention_cuda

    tok = ctx["tok"]
    docs = long_documents(tok, ctx["corpus"][:24_000], np.random.default_rng(6), 8, 0)
    params, arch = long_arch_params(torch)
    arch = arch.replace(attention_window=0, window_global_cls=False)
    enc = SentenceEncoder(params, arch, tokenizer=tok, device="cuda")
    seq = make_mesh(data=1, seq=SHARDS, devices=["cuda:0"] * SHARDS)
    ids, mask = tok.encode_batch(docs, 4096)
    ids = np.pad(ids, ((0, 0), (0, 4096 - ids.shape[1])), constant_values=tok.pad_id)
    mask = np.pad(mask, ((0, 0), (0, 4096 - mask.shape[1])))
    ids_t, mask_t = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    valid = mask_t.bool()
    both = valid & valid.roll(1, 0)
    with torch.no_grad():
        before = flash_attention_cuda.launches
        ref = encoder_forward(enc.params, ids_t, mask_t, arch=arch,
                              precision=enc.precision).last_hidden_state.float()
        k5 = flash_attention_cuda.launches - before
        agree = {}
        for strategy in ("ring", "ulysses"):
            h = encoder_forward_cp(enc.params, ids_t, mask_t, arch=arch, mesh=seq,
                                   strategy=strategy, precision=enc.precision).float()
            diff = (h - ref).abs()[valid]
            agree[strategy] = (float(diff.mean()), float(diff.max()),
                               float((h - ref.roll(1, 0)).abs()[both].mean()))
    rates = {}
    kw = dict(max_len=4096, buckets=(4096,), batch_size=8, packed=False)
    enc.encode(docs, **kw)
    torch.cuda.synchronize()
    t = time.time()
    single = enc.encode(docs, **kw)
    torch.cuda.synchronize()
    rates["single device (K5)"] = len(docs) / (time.time() - t)
    vecs = {}
    for strategy in ("ring", "ulysses"):
        enc.encode_long(docs[:2], seq, max_len=4096, strategy=strategy, batch_size=8)
        torch.cuda.synchronize()
        t = time.time()
        vecs[strategy] = enc.encode_long(docs, seq, max_len=4096, strategy=strategy,
                                         batch_size=8)
        torch.cuda.synchronize()
        rates[strategy] = len(docs) / (time.time() - t)
    cos = {s: float((v * single).sum(axis=1).min()) for s, v in vecs.items()}
    cos_next = {s: float((v * np.roll(single, 1, axis=0)).sum(axis=1).max())
                for s, v in vecs.items()}
    for strategy, (mean, worst, control) in agree.items():
        log(f"context-parallel {strategy} (seq {SHARDS}) against the single-device exact path "
            f"(K5, {k5} launches), 8 x 4096 roberta-base bf16: last_hidden_state mean|Δ| "
            f"{mean:.3e}, max|Δ| {worst:.3e} (the next document's rows: mean|Δ| {control:.3e}); "
            f"encode_long min cosine to encode {cos[strategy]:.7f} (gate {LONG_MIN_COS}; the "
            f"next document's vector: max cosine {cos_next[strategy]:.7f})")
    log("long encode docs/s [" + card + f", {ONE_CARD}]: "
        + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))

    # the card against the CPU, a 2-layer cut, f32, one document
    cut, cut_arch = long_arch_params(torch, layers=2)
    cut_arch = cut_arch.replace(attention_window=0, window_global_cls=False)
    worst_cpu = {}
    with torch.no_grad():
        for strategy in ("ring", "ulysses"):
            out = {}
            for dev in ("cpu", "cuda:0"):
                mesh = make_mesh(data=1, seq=SHARDS, devices=[dev] * SHARDS)
                out[dev] = encoder_forward_cp(
                    replicate(mesh, cut, SEQ_AXIS)[0], ids_t[:1].to(dev), mask_t[:1].to(dev),
                    arch=cut_arch, mesh=mesh, strategy=strategy,
                    precision=FP32_PRECISION).cpu()
            worst_cpu[strategy] = float((out["cuda:0"] - out["cpu"])[mask_t[:1].cpu().bool()]
                                        .abs().max())
    log(f"context-parallel on the card against the CPU (2 layers, 1 x 4096, f32): max|Δ| "
        f"{worst_cpu} (gate {CP_CARD_CPU})")
    if k5 != arch.num_layers:
        raise AssertionError(f"the single-device path launched K5 {k5} times, expected "
                             f"{arch.num_layers}")
    for strategy, (mean, worst, control) in agree.items():
        if mean > AGREE_MEAN or worst > AGREE_MAX:
            raise AssertionError(f"{strategy}: the context-parallel and the K5 path disagree "
                                 f"(mean|Δ| {mean:.3e}, max|Δ| {worst:.3e})")
        if control < 10 * AGREE_MEAN:
            raise AssertionError(f"{strategy}: the next document's rows differ by only "
                                 f"{control:.3e}")
    if max(worst_cpu.values()) > CP_CARD_CPU:
        raise AssertionError(f"context-parallel card against CPU: {worst_cpu}")
    for strategy in vecs:
        if cos[strategy] < LONG_MIN_COS:
            raise AssertionError(f"{strategy}: encode_long min cosine to encode "
                                 f"{cos[strategy]:.7f} below {LONG_MIN_COS}")
        if cos_next[strategy] >= LONG_MIN_COS:
            raise AssertionError(f"{strategy}: the next document's vector reaches cosine "
                                 f"{cos_next[strategy]:.7f}, the gate cannot tell them apart")


def phase_distributed(torch, card, ctx, corpus, queries, exact, ivf):
    """Phase 14: the distributed serving path; → K1's and K2's launches in
    its counted window (the sharded pipelines' serving)."""
    t0 = time.time()
    sharded_ivf_records(torch, card, corpus, queries, exact, ivf)
    sharded_brute_records(torch, card, ctx)
    launches = sharded_pipeline_records(torch, card, ctx)
    context_parallel_records(torch, card, ctx)
    log(f"phase 14: {time.time() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 15: distributed training on the one card
# ---------------------------------------------------------------------------

POSITIONS = 4
ONE_CARD_TRAIN = f"{POSITIONS} positions on one card"
# phase 7's gradient limits (worst leaf ‖Δg‖ / ‖g‖; another batch at least
# 10x the bf16 limit away); the same limits hold the parameters' movement
# after 4 steps (‖Δp‖ / ‖p − p0‖ of the mesh-less run's). The sharded path
# only reorders sums, so in f32 it must meet GRAD_F32. In bf16 a leaf whose
# gradient is a sum that cancels (a LayerNorm bias, the token-type row)
# moves with every rounding: the mesh-less bf16 step itself lies 13.5% from
# its f32 step on minilm-l6's mlp_ln bias (a CPU rehearsal). Two bf16 runs
# that each lie within r of the f32 run lie within 2r of each other, so a
# bf16 leaf is held to GRAD_BF16 or, where larger, to twice that leaf's
# distance between the mesh-less bf16 and f32 runs (BF16_RESOLUTION). The
# parameters after the steps are held to GRAD_BF16 in f32 too: AdamW divides
# each element by its own gradient's root mean square, so an element whose
# gradient is near zero turns its rounding into a step of its own (an H100
# read 1.35e-3 on attn/o/b, where the f32 gradients agree to 6.9e-5).
BF16_RESOLUTION = 2.0
DIST_PAIRS, DIST_LEN, DIST_STEPS, DIST_TIMED = 64, 128, 4, 10


def whole_flat(tree):
    """A (possibly sharded) tree's leaves whole, f32, by path."""
    from text_similarity_tpu_torch.core.mesh import unshard

    return {k: v.detach().float().clone() for k, v in flat_leaves(unshard(tree)).items()}


def grads_of(loss_fn, params, batch, *args):
    """(loss, the gradient of every leaf whole by path) of ``loss_fn``."""
    from text_similarity_tpu_torch.train.steps import value_and_grad

    loss, _, g = value_and_grad(loss_fn, params, batch, *args)
    return float(loss.detach()), whole_flat(g)


def gate_leaves(label, per, limit, card, noise=None, extra=""):
    """Every leaf's reading within ``limit`` or, where larger, the leaf's
    bf16 resolution in ``noise``."""
    allowed = {k: max(limit, (noise or {}).get(k, 0.0)) for k in per}
    worst = max(per, key=lambda k: per[k] / allowed[k])
    over = sorted(k for k in per if per[k] > limit)
    log(f"{label} [{card}, {ONE_CARD_TRAIN}]: per leaf max {per[worst]:.3e} ({worst}, allowed "
        f"{allowed[worst]:.3e}), median {float(np.median(list(per.values()))):.3e} (limit "
        f"{limit}{'; above it, within the bf16 resolution: ' + str(over) if over else ''}){extra}")
    if per[worst] > allowed[worst]:
        raise AssertionError(f"{label}: {worst} differs by {per[worst]:.3e} > {allowed[worst]:.3e}")


def gate_grads(label, got, want, control, limit, card, noise=None):
    """``got`` against ``want``: per leaf ‖Δg‖/‖g‖ (``gate_leaves``);
    ``control`` (another batch's gradient) at least 10 × the bf16 limit
    away."""
    per, whole, floored = grad_rel(got, want)
    _, ctrl, _ = grad_rel(control, want)
    gate_leaves(f"{label}: ‖Δg‖/‖g‖", per, limit, card, noise,
                f"; all leaves {whole:.3e}; another batch {ctrl:.3e} (must be >= "
                f"{10 * GRAD_BF16:.2e}); against 1e-3 of the whole norm: {floored}")
    if ctrl < 10 * GRAD_BF16:
        raise AssertionError(f"{label}: another batch's gradient differs by only {ctrl:.3e}")


def moved_rel(got, want, start, skip=()):
    """Per leaf ‖p − p_ref‖ / ‖p_ref − p0‖ of the leaves that moved, but for
    ``skip``: leaves whose gradient is rounding noise (below 1e-3 of the
    whole gradient's norm, such as the key bias, zero in exact arithmetic),
    which AdamW's normalisation turns into full-size steps."""
    per = {}
    for k, ref in want.items():
        moved = float((ref - start[k]).norm())
        if moved > 0 and k not in skip:
            per[k] = float((got[k] - ref).norm()) / moved
    return per


def dist_text_pairs(corpus, rng, n):
    """n pairs of texts of three corpus sentences each."""
    idx = rng.choice(len(corpus), (n, 2, 3))
    return [(" ".join(corpus[i] for i in a), " ".join(corpus[i] for i in b)) for a, b in idx]


def piece_bytes(torch, tree, device_index):
    """Bytes of the pieces (or whole leaves) a position holds: every piece
    of a sharded leaf whose place in its grid names the position on the
    data axis, a replicated leaf's one piece on position 0."""
    total = 0
    for leaf in flat_leaves(tree).values():
        pieces = getattr(leaf, "pieces", [leaf])
        if len(pieces) == POSITIONS:
            total += pieces[device_index].numel() * pieces[device_index].element_size()
        elif device_index == 0:
            total += sum(p.numel() * p.element_size() for p in pieces)
    return total


def dp_fsdp_records(torch, card, ctx):
    """minilm-l6 at full width, MNRL on 64 pairs × 128 tokens (f32 master
    weights, bf16 compute; f32 beside it; dropout 0): data 4 and FSDP 4
    against the mesh-less step → the data-parallel state after its steps
    and the arch (for the save → load → search check)."""
    from text_similarity_tpu_torch.core.config import TrainConfig
    from text_similarity_tpu_torch.core.mesh import make_mesh
    from text_similarity_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from text_similarity_tpu_torch.data.pairs import build_pair_batches
    from text_similarity_tpu_torch.models import fsdp_param_pspecs
    from text_similarity_tpu_torch.train import (
        init_sharded_train_state, init_train_state, make_bi_encoder_train_step, make_optimizer,
        shard_batch_for,
    )
    from text_similarity_tpu_torch.train.steps import batch_to, bi_encoder_loss

    tok, dev = ctx["tok"], torch.device("cuda")
    arch = ctx["enc"].arch.replace(hidden_dropout=0.0, attention_dropout=0.0)
    params = dict(ctx["params"])
    pad = -arch.vocab_size % POSITIONS     # FSDP splits the word table's rows
    if pad:
        emb = dict(params["embeddings"])
        emb["word"] = torch.cat([emb["word"], emb["word"].new_zeros((pad, arch.hidden_size))])
        params["embeddings"] = emb
        arch = arch.replace(vocab_size=arch.vocab_size + pad)
    params = {"encoder": params}
    rng = np.random.default_rng(15)
    batches = [build_pair_batches(tok, dist_text_pairs(ctx["corpus"], rng, DIST_PAIRS),
                                  np.zeros(DIST_PAIRS, np.float32), batch_size=DIST_PAIRS,
                                  max_len=DIST_LEN, shuffle=False)[0] for _ in range(2)]
    widths = [b["ids_a"].shape[1] for b in batches]
    b0, b1 = (batch_to(b, dev) for b in batches)
    cfg = TrainConfig(lr=2e-5, warmup_ratio=0.1)
    precisions = {"bf16": DEFAULT_PRECISION, "f32": FP32_PRECISION}

    def mnrl(precision):
        def loss_fn(p, batch, generator):
            return bi_encoder_loss(p, batch, arch=arch, loss_type="mnrl", precision=precision,
                                   deterministic=True)
        return loss_fn

    def run(state, tx, mesh, precision):
        """DIST_STEPS steps on the first batch (the first has lr 0) → (the
        parameters after them, then pairs/s over DIST_TIMED more steps)."""
        step = make_bi_encoder_train_step(arch, tx, loss_type="mnrl", precision=precision)
        placed = batches[0] if mesh is None else shard_batch_for(mesh, batches[0])
        for _ in range(DIST_STEPS):
            state, _ = step(state, placed)
        after = whole_flat(state.params)
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(DIST_TIMED):
            state, _ = step(state, placed)
        torch.cuda.synchronize()
        return after, DIST_PAIRS * DIST_TIMED / (time.time() - t)

    ref = {}
    for name, precision in precisions.items():
        tx = make_optimizer(cfg, DIST_STEPS, params)
        state = init_train_state(params, tx, device=dev)
        loss, g = grads_of(mnrl(precision), state.params, b0, None)
        _, ctrl = grads_of(mnrl(precision), state.params, b1, None)
        start = whole_flat(state.params)
        after, pps = run(state, tx, None, precision)
        ref[name] = {"loss": loss, "g": g, "ctrl": ctrl, "after": after, "pps": pps}
        del state, tx
    # how far bf16 compute itself moves each leaf: the mesh-less bf16 run
    # against the mesh-less f32 run
    g_noise, _, noisy = grad_rel(ref["bf16"]["g"], ref["f32"]["g"])
    p_noise = moved_rel(ref["f32"]["after"], ref["bf16"]["after"], start, noisy)
    g_noise = {k: BF16_RESOLUTION * v for k, v in g_noise.items()}
    p_noise = {k: BF16_RESOLUTION * v for k, v in p_noise.items()}

    out = {}
    for label, specs in (("data 4", None), ("FSDP 4", {"encoder": fsdp_param_pspecs(arch)})):
        mesh = make_mesh(data=POSITIONS, devices=[dev] * POSITIONS)
        for name, precision in precisions.items():
            tx = make_optimizer(cfg, DIST_STEPS, params)
            state = init_sharded_train_state(params, tx, mesh, param_specs=specs)
            loss, g = grads_of(mnrl(precision), state.params, b0, None)
            log(f"{label} MNRL loss {name} {loss:.6f} against the mesh-less step's "
                f"{ref[name]['loss']:.6f} (64 pairs at widths {widths}, minilm-l6)")
            if abs(loss - ref[name]["loss"]) > GRAD_F32 * abs(ref[name]["loss"]):
                raise AssertionError(f"{label} {name}: the loss differs: {loss} against "
                                     f"{ref[name]['loss']}")
            limit = GRAD_BF16 if name == "bf16" else GRAD_F32
            noise = g_noise if name == "bf16" else None
            gate_grads(f"{label} MNRL gradients {name} against the mesh-less step's", g,
                       ref[name]["g"], ref[name]["ctrl"], limit, card, noise)
            if specs is not None and name == "bf16":
                leaves = flat_leaves(state.params)
                split = {k: v for k, v in leaves.items() if len(v.pieces) > 1}
                for k, v in split.items():
                    if any(p.numel() * POSITIONS != v.shape.numel() for p in v.pieces):
                        raise AssertionError(f"FSDP piece of {k} is not 1/{POSITIONS} of the leaf")
                rep_bytes = sum(v.shape.numel() * 4 for v in leaves.values())
                held = [(piece_bytes(torch, state.params, i),
                         2 * piece_bytes(torch, state.opt_state["mu"], i))
                        for i in range(POSITIONS)]
                first = next(iter(split))
                log(f"FSDP {POSITIONS}: {len(split)} of {len(leaves)} leaves split, each piece "
                    f"1/{POSITIONS} (e.g. {first} {tuple(split[first].pieces[0].shape)} of "
                    f"{tuple(split[first].shape)}); bytes a position (parameters, moments mu + "
                    f"nu; the replicated leaves on position 0): {held}; replicated: {rep_bytes} "
                    f"and {2 * rep_bytes} at every position")
            after, pps = run(state, tx, mesh, precision)
            if label == "data 4" and name == "bf16":
                out["state"] = state    # trained further in the timed window
            per = moved_rel(after, ref[name]["after"], start, noisy)
            gate_leaves(f"{label} parameters {name} after {DIST_STEPS} steps against the mesh-less "
                        f"run's: ‖p − p_ref‖/‖p_ref − p0‖ (not gated: {noisy})", per, GRAD_BF16,
                        card, p_noise if name == "bf16" else None)
            log(f"{label} MNRL step {name} [{card}, {ONE_CARD_TRAIN}]: {pps:.1f} pairs/s against "
                f"the mesh-less step's {ref[name]['pps']:.1f} ({DIST_TIMED} steps each)")
            del state, tx
    return out["state"], arch


def timed_step(torch, step, state, batch):
    """One step (lr 0), then one timed and counted → (its metrics, seconds,
    (K5, K6) launches)."""
    from text_similarity_tpu_torch.ops.attention import (
        flash_attention_backward_cuda, flash_attention_cuda,
    )

    state, _ = step(state, batch)
    torch.cuda.synchronize()
    flash_attention_cuda.launches = flash_attention_backward_cuda.launches = 0
    t = time.time()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    return m, time.time() - t, (flash_attention_cuda.launches,
                                flash_attention_backward_cuda.launches)


def tp_pp_records(torch, card, ctx, pairs):
    """roberta-base at 4,098 positions (phase 6's weights), window 256 +
    CLS, dropout 0: data 2 × model 2 and pipe 4 × 4 microbatches against
    the mesh-less path, gradients in bf16 and f32 → K5's and K6's launches
    in the counted (bf16) steps."""
    from text_similarity_tpu_torch.core.config import TrainConfig
    from text_similarity_tpu_torch.core.mesh import make_mesh
    from text_similarity_tpu_torch.core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from text_similarity_tpu_torch.data.pairs import build_pair_batches
    from text_similarity_tpu_torch.models import encoder_forward, encoder_forward_pp, param_pspecs
    from text_similarity_tpu_torch.train import (
        init_sharded_train_state, init_train_state, make_bi_encoder_train_step, make_optimizer,
        shard_batch_for,
    )
    from text_similarity_tpu_torch.train.steps import batch_to

    tok, dev = ctx["tok"], torch.device("cuda")
    params, arch = long_arch_params(torch)
    arch = arch.replace(hidden_dropout=0.0, attention_dropout=0.0)
    params = {"encoder": params}
    # the control: 4 other pairs of 1,500-2,500 tokens (4 pairs like the
    # first batch's average their documents' common part, which random
    # weights make large: other 3,000-4,000-token documents read 0.3004)
    other = document_pairs(tok, ctx["corpus"][-24_000:], np.random.default_rng(17), 4,
                           lengths=(1500, 2501))
    batches = [build_pair_batches(tok, group, np.zeros(4, np.float32), batch_size=4,
                                  max_len=TRAIN_BUCKET, shuffle=False)[0]
               for group in (pairs[:4], other)]
    if any(b["ids_a"].shape[1] != TRAIN_BUCKET for b in batches):
        raise AssertionError(f"the pairs are not at bucket {TRAIN_BUCKET}")
    w = torch.randn(TRAIN_BUCKET, arch.hidden_size,
                    generator=torch.Generator(device=dev).manual_seed(15), device=dev)
    pp_mesh = make_mesh(data=1, pipe=POSITIONS, devices=[dev] * POSITIONS)

    def projection(precision, pp=False):
        """A fixed random projection of both towers' states (phase 7's
        gradient loss: a pair loss is ill-conditioned on random weights)."""
        def loss_fn(p, batch, generator):
            total = 0.0
            for side in ("a", "b"):
                ids, mask = batch[f"ids_{side}"], batch[f"mask_{side}"]
                if pp:
                    h = encoder_forward_pp(p["encoder"], ids, mask, arch=arch, mesh=pp_mesh,
                                           microbatches=POSITIONS, precision=precision)
                else:
                    h = encoder_forward(p["encoder"], ids, mask, arch=arch,
                                        precision=precision).last_hidden_state
                total = total + (h.float() * w * mask[..., None]).sum()
            return total, {}
        return loss_fn

    cfg = TrainConfig(lr=2e-5, warmup_ratio=0.1)
    precisions = {"bf16": DEFAULT_PRECISION, "f32": FP32_PRECISION}
    b0, b1 = (batch_to(b, dev) for b in batches)
    tx = make_optimizer(cfg, 4, params)
    ref = init_train_state(params, tx, device=dev)
    plain_s = timed_step(torch, make_bi_encoder_train_step(arch, tx, loss_type="mnrl"), ref,
                         batches[0])[1]
    ref = init_train_state(params, tx, device=dev)
    want = {name: grads_of(projection(prec), ref.params, b0, None)[1]
            for name, prec in precisions.items()}
    ctrl = grads_of(projection(DEFAULT_PRECISION), ref.params, b1, None)[1]
    noise = {k: BF16_RESOLUTION * v for k, v in grad_rel(want["bf16"], want["f32"])[0].items()}

    def gate(label, params_, pp=False):
        for name, prec in precisions.items():
            got = grads_of(projection(prec, pp), params_, b0, None)[1]
            gate_grads(f"{label} gradients {name} against the mesh-less path's (roberta-base, "
                       f"4 pairs at 4096, window 256 + CLS)", got, want[name], ctrl,
                       GRAD_BF16 if name == "bf16" else GRAD_F32, card,
                       noise if name == "bf16" else None)

    # data 2 × model 2: K5 / K6 on each model position's 6 heads
    mesh = make_mesh(data=2, model=2, devices=[dev] * POSITIONS)
    tx = make_optimizer(cfg, 4, params)
    state = init_sharded_train_state(params, tx, mesh, {"encoder": param_pspecs(arch)})
    gate("data 2 × model 2", state.params)
    placed = shard_batch_for(mesh, batches[0])
    step = make_bi_encoder_train_step(arch, tx, loss_type="mnrl")
    launches = {}
    m, tp_s, launches["tp"] = timed_step(torch, step, state, placed)
    log(f"data 2 × model 2 MNRL step bf16 [{card}, {ONE_CARD_TRAIN}]: loss {float(m['loss']):.5f}, "
        f"{4 / tp_s:.2f} pairs/s (mesh-less {4 / plain_s:.2f}); K5 {launches['tp'][0]} and K6 "
        f"{launches['tp'][1]} launches (expected 12 layers x 2 towers x 4 positions = 96, K6 2 x "
        f"that)")
    del state, tx, step

    # pipe 4 × 4 microbatches of one row: 3 layers a stage
    with torch.no_grad():
        ids, mask = b0["ids_a"], b0["mask_a"]
        plain = encoder_forward(ref.params["encoder"], ids, mask, arch=arch).last_hidden_state
        piped = encoder_forward_pp(ref.params["encoder"], ids, mask, arch=arch, mesh=pp_mesh,
                                   microbatches=POSITIONS)
        valid = mask.bool()
        diff = (piped.float() - plain.float()).abs()[valid]
        other = (piped.float() - plain.float().roll(1, 0)).abs()[valid & valid.roll(1, 0)]
    log(f"pipe {POSITIONS} x {POSITIONS} microbatches against encoder_forward, 4 x 4096 "
        f"roberta-base bf16, valid rows: mean|Δ| {float(diff.mean()):.3e}, max|Δ| "
        f"{float(diff.max()):.3e} (the next document's rows: mean|Δ| {float(other.mean()):.3e})")
    if float(diff.mean()) > AGREE_MEAN or float(diff.max()) > AGREE_MAX:
        raise AssertionError("the pipelined forward differs from encoder_forward")
    if float(other.mean()) < 10 * AGREE_MEAN:
        raise AssertionError("the next document's rows are within the agreement gate")
    del plain, piped, diff, other
    gate(f"pipe {POSITIONS}", ref.params, pp=True)
    del want, ctrl
    tx = make_optimizer(cfg, 4, params)
    pp_state = init_train_state(params, tx, device=dev)
    pp_step = make_bi_encoder_train_step(arch, tx, loss_type="mnrl", pp_mesh=pp_mesh,
                                         pp_microbatches=POSITIONS)
    m, pp_s, launches["pp"] = timed_step(torch, pp_step, pp_state, batches[0])
    log(f"pipe {POSITIONS} MNRL step [{card}, {ONE_CARD_TRAIN}]: loss {float(m['loss']):.5f}, "
        f"{4 / pp_s:.2f} pairs/s (mesh-less {4 / plain_s:.2f}); K5 {launches['pp'][0]} and K6 "
        f"{launches['pp'][1]} launches (expected 12 layers x 2 towers x 4 microbatches = 96, K6 "
        f"2 x that)")
    del pp_state, tx, pp_step

    # dropout on: a finite loss, and identical microbatches draw other masks
    drop_arch = arch.replace(hidden_dropout=0.1)
    tx = make_optimizer(cfg, 4, params)
    st = init_train_state(params, tx, device=dev)
    drop_step = make_bi_encoder_train_step(drop_arch, tx, loss_type="mnrl", pp_mesh=pp_mesh)
    st, m = drop_step(st, batches[0])
    with torch.no_grad():
        same = b0["ids_a"][:1].repeat(POSITIONS, 1), b0["mask_a"][:1].repeat(POSITIONS, 1)
        rows = encoder_forward_pp(st.params["encoder"], *same, arch=drop_arch, mesh=pp_mesh,
                                  deterministic=False, generator=st.rng)
        apart = float((rows[0].float() - rows[1].float()).abs().max())
    log(f"pipe {POSITIONS} with dropout 0.1: MNRL loss {float(m['loss']):.5f}; two identical "
        f"microbatches differ by max|Δ| {apart:.3e}")
    if not np.isfinite(float(m["loss"])) or apart == 0.0:
        raise AssertionError("the pipelined step with dropout: a non-finite loss or shared masks")
    del st, tx, drop_step, ref
    lens = b0["mask_a"].sum(1).tolist()
    tp_kernels_held(torch, card, lens)
    for name, (k5, k6) in launches.items():
        if k5 != 96 or k6 != 192:
            raise AssertionError(f"{name}: K5 / K6 launched {k5} / {k6}, expected 96 / 192")
    return {"K5": launches["tp"][0] + launches["pp"][0],
            "K6": launches["tp"][1] + launches["pp"][1]}


def tp_kernels_held(torch, card, lengths):
    """K5 and K6 against their plain versions at the shape a model position
    gives them: (2, 4096, 6, 64) bf16, window 256 + CLS, q, k, v as views of
    the position's fused QKV (phase 6's and 7's gates); then at the pipe's
    one-row microbatch, 12 heads."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    for b, h, lens in ((2, 6, lengths[:2]), (1, 12, lengths[:1])):
        x = torch.randn(b, TRAIN_BUCKET, h, 3, 64, generator=g, device=dev).to(torch.bfloat16)
        q, k, v = x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        err, mean, lse_err, zero_ok = flash_case(torch, q, k, v, ln, 256, True)
        ok5 = err <= 1e-2 and mean <= 5e-4 and lse_err <= 1e-4
        err6, mean6, rel6, _ = k6_case(torch, q, k, v, ln, 256, True, g)
        ok6 = rel6 <= K6_BF16_REL and mean6 <= K6_BF16_MEAN
        log(f"K5 at ({b}, {TRAIN_BUCKET}, {h}, 64) bf16 window 256 + CLS lens {list(lens)}: "
            f"max|Δ| {err:.2e}, mean|Δ| {mean:.2e}, lse {lse_err:.2e} -> "
            f"{'ok' if ok5 else 'FAIL'}; "
            f"K6 max|Δ|/max(1,|ref|) {rel6:.3e}, mean|Δ| {mean6:.3e} -> "
            f"{'ok' if ok6 else 'FAIL'} [{card}]")
        if not (ok5 and ok6):
            raise AssertionError(f"K5 / K6 disagree with their plain versions at ({b}, "
                                 f"{TRAIN_BUCKET}, {h}, 64)")


def ep_records(torch, card, ctx):
    """minilm-l6 with 8 experts, top-2, data 2 × expert 2, f32 (a routing
    decision flips on a bf16 rounding): the forward's states, moe_aux and
    moe_drop against the replicated forward; one step's gradients."""
    from text_similarity_tpu_torch.core.config import ARCH_PRESETS
    from text_similarity_tpu_torch.core.mesh import make_mesh, place
    from text_similarity_tpu_torch.core.precision import FP32_PRECISION
    from text_similarity_tpu_torch.data.pairs import build_pair_batches
    from text_similarity_tpu_torch.models import encoder_forward, init_params, param_pspecs
    from text_similarity_tpu_torch.train.steps import batch_to, bi_encoder_loss, trainable

    tok, dev = ctx["tok"], torch.device("cuda")
    arch = ARCH_PRESETS["minilm-l6"].replace(num_experts=8, expert_top_k=2, hidden_dropout=0.0,
                                             attention_dropout=0.0)
    params = init_params(arch, torch.Generator().manual_seed(15))
    rng = np.random.default_rng(16)
    batches = [build_pair_batches(tok, dist_text_pairs(ctx["corpus"], rng, 32),
                                  np.zeros(32, np.float32), batch_size=32, max_len=DIST_LEN,
                                  shuffle=False)[0] for _ in range(2)]
    mesh = make_mesh(data=2, expert=2, devices=[dev] * POSITIONS)
    placed = place(params, mesh, param_pspecs(arch))
    b0 = batch_to(batches[0], dev)
    with torch.no_grad():
        want = encoder_forward(trainable(params, dev), b0["ids_a"], b0["mask_a"], arch=arch,
                               precision=FP32_PRECISION)
        got = encoder_forward(placed, b0["ids_a"], b0["mask_a"], arch=arch,
                              precision=FP32_PRECISION)
    rel = float((got.last_hidden_state - want.last_hidden_state).norm()
                / want.last_hidden_state.norm())
    d_aux, d_drop = abs(float(got.moe_aux - want.moe_aux)), abs(float(got.moe_drop - want.moe_drop))
    log(f"expert 2 x data 2 forward against the replicated forward (minilm-l6, 8 experts, top-2, "
        f"32 x {b0['ids_a'].shape[1]}, f32) [{card}, {ONE_CARD_TRAIN}]: states ‖Δ‖/‖ref‖ "
        f"{rel:.3e}; moe_aux {float(got.moe_aux):.6f} (|Δ| {d_aux:.1e}), moe_drop "
        f"{float(got.moe_drop):.6f} (|Δ| {d_drop:.1e})")
    if rel > GRAD_F32 or d_aux > 1e-5 or d_drop > 1e-5:
        raise AssertionError("the expert-parallel forward differs from the replicated one")

    def loss_fn(p, batch, generator):
        return bi_encoder_loss(p, batch, arch=arch, loss_type="mnrl", precision=FP32_PRECISION,
                               deterministic=True)

    ref = trainable({"encoder": params}, dev)
    _, ref_g = grads_of(loss_fn, ref, b0, None)
    _, ctrl_g = grads_of(loss_fn, ref, batch_to(batches[1], dev), None)
    _, g = grads_of(loss_fn, trainable({"encoder": placed}), b0, None)
    gate_grads("expert 2 x data 2 MNRL gradients against the replicated step's (f32)", g, ref_g,
               ctrl_g, GRAD_F32, card)


def phase_distributed_training(torch, card, ctx, pairs):
    """Phase 15: distributed training, every position on the one card →
    K5's and K6's launches in its counted steps (data 2 × model 2 and pipe
    4)."""
    import tempfile

    from text_similarity_tpu_torch.cli.main import main as cli_main
    from text_similarity_tpu_torch.core.mesh import unshard
    from text_similarity_tpu_torch.dryrun import dryrun_multichip
    from text_similarity_tpu_torch.models import SentenceEncoder
    from text_similarity_tpu_torch.ops.topk import cosine_topk_cuda

    t0 = time.time()
    dp_state, arch = dp_fsdp_records(torch, card, ctx)
    launches = tp_pp_records(torch, card, ctx, pairs)
    tok = ctx["tok"]
    ep_records(torch, card, ctx)
    t = time.time()
    dry = dryrun_multichip(POSITIONS)
    log(f"dryrun_multichip({POSITIONS}) on the card: {time.time() - t:.1f} s, recall@10 "
        f"{dry['recall_at_10']:.2f}, pp losses {dry['pp_losses']}, MoE {dry['moe']}")

    # the data-parallel encoder, unsharded, saved, loaded and searched (K2)
    docs = ctx["corpus"][:2000]
    with tempfile.TemporaryDirectory() as tmp:
        enc = SentenceEncoder(unshard(dp_state.params["encoder"]), arch, tokenizer=tok,
                              device="cuda")
        enc.save(os.path.join(tmp, "model"))
        loaded = SentenceEncoder.load(os.path.join(tmp, "model"), device="cuda")
        count = cosine_topk_cuda.launches
        found, low = self_retrieval(torch, enc, loaded, docs, card)
        k2 = cosine_topk_cuda.launches - count
    log(f"the data-parallel encoder unsharded, saved, loaded: K2 ({k2} launch) finds "
        f"{found}/{len(docs)} documents first (lowest top-1 score {low:.4f})")
    if found != len(docs) or k2 == 0:
        raise AssertionError("the data-parallel encoder did not survive save -> load -> search")

    n_cards = torch.cuda.device_count()
    stages = max(n_cards + 1, 2)
    try:   # the count is checked before the data is read
        cli_main(["train-sts", "--data", "unread.tsv", "--pipe", str(stages)])
        refused = None
    except SystemExit as e:
        refused = str(e)
    log(f"train-sts --pipe {stages} on this machine: {refused!r}")
    if refused is None or f"{n_cards} visible" not in refused:
        raise AssertionError(f"train-sts --pipe {stages} did not refuse naming the count")
    log(f"phase 15: {time.time() - t0:.1f} s")
    return launches


def main() -> int:
    sys.path.insert(0, REPO)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    try:
        from text_similarity_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {REPO}: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t = time.time()
    _cuda.build(verbose=True)
    _cuda.lib()
    log(f"kernels built in {time.time() - t:.1f} s")

    k2 = phase_topk(torch, card)
    k2_large, k3_large = phase_large_k(torch, card)
    k8 = phase_topk_2pass(torch, card)
    k1, (corpus, queries, exact, ivf) = phase_ivf(torch, card)
    k1_large = k1.pop("large_k")
    launches, ctx = phase_pipeline(torch, card)
    k3 = phase_int8_topk(torch, card)
    k3_large["launches"] = k3.pop("launches_large")
    k4, ivf8 = phase_int8_ivf(torch, card, corpus, queries, exact)
    k1_large.update(k4.pop("large_k"))
    modes = phase_ivf_options(torch, card, ivf, ivf8, corpus, queries, exact)
    del ivf8
    launches8 = phase_int8_pipeline(torch, card, ctx)
    k5 = phase_flash(torch, card)
    k5["launches"] = phase_long_documents(torch, card, ctx)
    k6 = phase_flash_backward(torch, card)
    k6["launches"], pairs = phase_long_training(torch, card, ctx)
    phase_grad_agreement(torch, card, ctx["tok"], pairs)
    phase_short_training(torch, card, ctx)
    k7 = phase_packed_attention(torch, card)
    k7["launches"] = phase_packed_encode(torch, card, ctx)
    phase_serving(torch, card, ctx)
    phase_training_entry_points(torch, card, ctx)
    phase_commands(torch, card, ctx, corpus, queries)
    phase_compression(torch, card, ctx)
    phase_moe_performer(torch, card, ctx)
    sharded = phase_distributed(torch, card, ctx, corpus, queries, exact.cpu().numpy(), ivf)
    distributed = phase_distributed_training(torch, card, ctx, pairs)
    kernels = [k1, k2, k3, k4, k5, k6, k7, *k8, *modes, k2_large, k3_large, k1_large]
    for kern in (k1, k2):
        kern["launches"] = launches[kern["name"]]
        kern["launches_sharded"] = sharded[kern["name"]]
    k2_large["launches"] = sharded["cosine_topk_large"]
    k5["launches_distributed"], k6["launches_distributed"] = distributed["K5"], distributed["K6"]
    for kern in (k3, k4):
        kern["launches"] = launches8[kern["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
