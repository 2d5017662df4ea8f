"""repro_torch.models — the LM substrate of every architecture family
(port of ``repro/models``).

- ``common``: ``Ctx``, dense, the norms, RoPE, the MLPs, embed/unembed;
- ``layers.attention``: GQA/MHA self-attention, chunked prefill, decode,
  cross-attention; ``layers.{moe,mla,mamba2,xlstm}``: MoE, MLA, Mamba2,
  mLSTM and sLSTM;
- ``kmeans_attention``: the clustered KV cache and cluster-routed
  attention on the port's k-means kernels (ROADMAP.md queue A item 7);
- ``transformer``: the grouped decoder stack (zamba2's shared block
  stored once, ``remat`` per group); ``model``: init, the encoder and
  frontends, the training loss, prefill, decode and the decode caches
  (dense, clustered);
- ``bridge``: the JAX package's weight and cache trees as numpy.

Serving and training over a mesh wait for queue A item 8a.
"""
