"""PyTorch / CUDA port of ``text_similarity_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; this package mirrors its
module layout and names so each counterpart is easy to find. It imports
``torch`` only (never ``jax`` nor the JAX package). Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU; nothing falls
back to the CPU on its own.

Ported so far: the semantic-search serving path — WordPiece tokenization
(the C matcher and packer under ``native/``, or a HuggingFace
``tokenizer.json``), the BERT-class sentence encoder, the embedding store,
brute-force and IVF top-k search, ``SemanticSearchPipeline`` (with add and
remove on a built index), the cross-encoder rerank (``RankingPipeline``)
and the HTTP daemon (``python -m text_similarity_tpu_torch serve``) — int8
serving: int8 weights (``SentenceEncoder.to_int8``), the
int8 store and int8 IVF slabs with a bf16 rescore — long-document encode
(windowed attention with a global CLS at 4096 tokens) and bi-encoder
training (``train``: the pair losses, AdamW, the train step, the Trainer).
The four search kernels (exact top-k and the IVF scan, each over float and
int8 rows) and the flash forward and backward are hand-written CUDA under
``csrc/``. The distributed serving path runs as one controller over a
``core.mesh.Mesh``: the sharded indexes (``index.sharded``) behind
``ShardedSearchPipeline`` and ``serve --shards``, the data-parallel encode
(``SentenceEncoder(mesh=)``) and the context-parallel long encode
(``models.long_context``, ring or Ulysses attention).
"""
