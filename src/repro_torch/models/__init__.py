"""Language models of the port: layers (GQA and MLA attention), the MoE and
the transformer stacks (dense, gemma2's local/global pairs, the MoE family)."""
