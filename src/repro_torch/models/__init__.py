"""The paper's GNN workload on the port."""
