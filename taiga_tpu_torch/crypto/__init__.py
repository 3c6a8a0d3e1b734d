"""Host-side cryptographic primitives (exact, Python-int based).

These are the bit-exact reference implementations that the TPU kernels in
`taiga_tpu.ops` are differentially tested against. Hot paths (batched hashing,
MSM, NTT) run on TPU; single-shot host operations (transcripts, signatures,
serialization) live here.
"""
