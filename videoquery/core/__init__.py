from videoquery.core.config import (
    BrokerConfig,
    ExtractionConfig,
    HyperParams,
    SearchConfig,
    compute_eps,
)

# meshes (jax) is not re-exported: host-side worker processes import
# videoquery.core.config and must not pay for, or risk, a jax import

__all__ = [
    "BrokerConfig",
    "ExtractionConfig",
    "HyperParams",
    "SearchConfig",
    "compute_eps",
]
