from .registry import ASSET_REGISTRY, asset_path, write_artifacts
from .part0 import run_part0
from .part1 import run_part1
from .part2 import run_part2

__all__ = ["ASSET_REGISTRY", "asset_path", "write_artifacts", "run_part0",
           "run_part1", "run_part2"]
