from ray_tpu_torch.models import convert, gpt2, llama, mlp, moe, vit

__all__ = ["convert", "gpt2", "llama", "mlp", "moe", "vit"]
