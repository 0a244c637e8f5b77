"""Language models of the port: layers (GQA and MLA attention), the MoE,
Mamba-2 (``ssm``) and the model stacks of every family (dense, gemma2's
local/global pairs, the MoE family, SSM, the zamba2 hybrid, whisper's
encoder-decoder, the VLM)."""
