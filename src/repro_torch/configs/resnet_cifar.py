"""Paper-native CNN configs: ResNet-56 / ResNet-110 on CIFAR-shaped inputs.

Verbatim copy of ``repro/configs/resnet_cifar.py:1``.

These reproduce the paper's own experiments (Tables 1-5, Fig 2-3): bottleneck
residual stacks split into 8 modules md1..md8 exactly as Appendix A.5
(Tables 8/9), with avgpool+fc auxiliary heads per tier (Table 10).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ResNetConfig:
    name: str
    # number of bottleneck blocks per stage (3 stages; ResNet-6n+2: n per stage)
    blocks_per_stage: int
    n_classes: int = 10
    width: int = 16          # stem channels; stages are 16/32/64 bottleneck mid-channels
    image_size: int = 32
    n_modules: int = 8
    source: str = "arXiv He et al. 2016; DTFL Appendix A.5"

    @property
    def n_blocks(self) -> int:
        return 3 * self.blocks_per_stage

    def reduced(self) -> "ResNetConfig":
        return ResNetConfig(
            name=self.name + "-reduced",
            blocks_per_stage=1,
            n_classes=self.n_classes,
            width=8,
            image_size=16,
            n_modules=4,
            source=self.source,
        )


RESNET56 = ResNetConfig(name="resnet-56", blocks_per_stage=6)    # 1 stem + 18 bottleneck*3 -> 56 layers
RESNET110 = ResNetConfig(name="resnet-110", blocks_per_stage=12)  # 110 layers

# 7-tier-capable reduced model (6 bottleneck blocks -> md2..md7 non-empty):
# the Table-1 protocol trains THIS at every static tier, priced on ResNet-110
RESNET_BENCH = ResNetConfig(name="resnet-bench", blocks_per_stage=2, width=8,
                            image_size=16, n_modules=8)

# engine-overhead micro model (width-4 / 8px): the table4 wall-time sweep's
# many-small-clients regime where dispatch count, not math, dominates
RESNET_MICRO = ResNetConfig(name="resnet-micro", blocks_per_stage=1, width=4,
                            image_size=8, n_modules=4)


def get_resnet(name: str) -> ResNetConfig:
    return {"resnet-56": RESNET56, "resnet-110": RESNET110,
            "resnet-bench": RESNET_BENCH, "resnet-micro": RESNET_MICRO}[name]
