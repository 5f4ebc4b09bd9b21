"""Mixed-precision policy (counterpart of ``idmvton_tpu/core/dtypes.py``).

The reference runs fp16 weights with an fp32 VAE decode
(reference: inference.py:223, src/tryon_pipeline.py:1868-1880 upcast_vae).
On the card, as on the TPU, the low-precision type is bfloat16: fp32's
exponent range, so the fp16-overflow workarounds the reference needs
(forced-fp32 VAE) are an option rather than a requirement.

Policy:
- ``param_dtype``  -- storage type of weights.
- ``compute_dtype``-- type activations and products run in (bf16 operands
  for the tensor cores).
- norms and softmax accumulate in fp32 whatever the policy.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def cast_to_param(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.param_dtype)


DEFAULT_POLICY = Policy(param_dtype=torch.bfloat16,
                        compute_dtype=torch.bfloat16)
FP32_POLICY = Policy(param_dtype=torch.float32, compute_dtype=torch.float32)
