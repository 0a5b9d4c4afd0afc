"""Sparse substrate: CSR/block-ELL containers and generators (numpy)."""
from repro_torch.sparse.csr import CSR, csr_from_coo, csr_from_dense, graph_signature
from repro_torch.sparse.bsr import (
    BlockELL,
    RaggedBlockELL,
    block_ell_edge_index,
    csr_to_block_ell,
    csr_to_ragged,
    hub_split,
)
from repro_torch.sparse.merge import MergePathELL, build_merge_path
from repro_torch.sparse.generators import (
    erdos_renyi,
    fixed_degree,
    hub_skew,
    power_law,
    products_like,
    reddit_like,
    regime_shift_stream,
    sample_subgraph_stream,
    single_hub,
    sliding_window_csr,
    table10_graph,
)

__all__ = [
    "CSR",
    "csr_from_coo",
    "csr_from_dense",
    "graph_signature",
    "BlockELL",
    "RaggedBlockELL",
    "block_ell_edge_index",
    "csr_to_block_ell",
    "csr_to_ragged",
    "hub_split",
    "MergePathELL",
    "build_merge_path",
    "erdos_renyi",
    "fixed_degree",
    "hub_skew",
    "power_law",
    "products_like",
    "reddit_like",
    "regime_shift_stream",
    "sample_subgraph_stream",
    "single_hub",
    "sliding_window_csr",
    "table10_graph",
]
