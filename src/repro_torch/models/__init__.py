"""repro_torch.models — the LM substrate of the dense-attention family
(port of ``repro/models``).

- ``common``: ``Ctx``, dense, the norms, RoPE, the MLPs, embed/unembed;
- ``layers.attention``: GQA/MHA self-attention, chunked prefill, decode;
- ``kmeans_attention``: the clustered KV cache and cluster-routed
  attention on the port's k-means kernels (ROADMAP.md queue A item 7);
- ``transformer``: the grouped decoder stack; ``model``: init, prefill,
  decode and the decode caches (dense, clustered);
- ``bridge``: the JAX package's weight and cache trees as numpy.

The other families (MLA, MoE, Mamba2, xLSTM, zamba2's hybrid, the VLM
frontend, whisper) and training wait for queue A items 8a and 8c.
"""
