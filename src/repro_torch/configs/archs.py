"""Imports every per-arch module so the registry is populated."""
import repro_torch.configs.phi3_mini_3_8b      # noqa: F401
import repro_torch.configs.starcoder2_15b      # noqa: F401
import repro_torch.configs.granite_3_8b        # noqa: F401
import repro_torch.configs.mistral_large_123b  # noqa: F401
import repro_torch.configs.whisper_small       # noqa: F401
import repro_torch.configs.kimi_k2_1t_a32b     # noqa: F401
import repro_torch.configs.moonshot_v1_16b_a3b # noqa: F401
import repro_torch.configs.llama_3_2_vision_11b # noqa: F401
import repro_torch.configs.recurrentgemma_9b   # noqa: F401
import repro_torch.configs.xlstm_350m          # noqa: F401
