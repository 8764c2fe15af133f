from pilottai_tpu_torch.prompts.manager import PromptManager

__all__ = ["PromptManager"]
