"""attention_roofline.train: roofline share of the CSR-attention
pipeline's hand kernels (kernels/{attention,sddmm,softmax}.py and the
SpMM kernels its backward runs, csrc/*.cu) over the attention step's
scheduled calls that ran on them (bench/roofline.py). Moves
train_step_ms."""

from bench import roofline

OPS = ("attention", "attention_bwd_e", "attention_bwd_p", "attention_bwd_q",
       "attention_bwd_k", "attention_bwd_v")


def read(r):
    return roofline.share(r, OPS, ("attention", "sddmm", "softmax", "spmm"))
