"""The benchmark's plain reference of PFV v2.1.1 (FORMAT.md): NumPy and
PyTorch only, independent of the program under test.

`tables`   the format's constant tables and the encoder's q-tables
`codec`    integer 8x8 transforms, dequantisation, block decode and the
           encoder (motion search, forward transform, quantisation, in-loop
           reconstruction), vectorised over blocks on any torch device
`entropy`  the RLE + Huffman payload writer (and a slow reader for tests)
`streams`  seeded per-block symbols drawn from a traffic file's statistics,
           written into a container, and decoded from the symbols alone
`sources`  seeded synthetic source clips for the encoder
`color`    4:2:0 planes -> packed RGBA words

Nothing here imports jax, pfv_tpu or pfv_torch.
"""
