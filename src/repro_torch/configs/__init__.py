"""Model configurations of the port.

``gengnn_models`` holds the paper's six GNNs.  The LM registry lists the
language models the port serves (copies of ``repro.configs``' modules of the same
names), all ten of its architectures: the dense GQA family, MLA
(MiniCPM3), the MoE family, the attention / Mamba hybrid (Jamba), the
attention-free RWKV-6, the VLM backbone (InternVL2) and the audio
encoder-decoder (Whisper).  ``get_config(arch)`` gives the published
configuration, ``get_reduced(arch)`` the same-family smoke-test
reduction.
"""
from importlib import import_module

REGISTRY = {
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "whisper-base": "repro_torch.configs.whisper_base",
}

ARCHS = tuple(REGISTRY)


def get_config(arch: str, **kw):
    return import_module(REGISTRY[arch]).get_config(**kw)


def get_reduced(arch: str, **kw):
    return import_module(REGISTRY[arch]).reduced_config(**kw)
