"""The paper's own workload: a 3-layer GraphSAGE / CSR-attention (GAT)
GNN over Reddit/Products-scale graphs, with AutoSAGE-scheduled SpMM/SDDMM.
Not part of the assigned LM pool; used by the GNN examples/benchmarks.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gnn-sage",
    family="gnn",
    n_layers=3,
    d_model=256,  # hidden feature width
    n_heads=1,
    n_kv_heads=1,
    d_ff=256,
    vocab=0,  # not a token model; features come from the graph
    source="paper §7",
)
