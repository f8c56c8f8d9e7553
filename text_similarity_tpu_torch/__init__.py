"""PyTorch / CUDA port of ``text_similarity_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; this package mirrors its
module layout and names so each counterpart is easy to find. It imports
``torch`` only (never ``jax`` nor the JAX package). Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU; nothing falls
back to the CPU on its own.

Ported so far: the semantic-search serving path — WordPiece tokenization,
the BERT-class sentence encoder, the embedding store, brute-force and IVF
top-k search (the two search kernels are hand-written CUDA under
``csrc/``) and ``SemanticSearchPipeline``.
"""
