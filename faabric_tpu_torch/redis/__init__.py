"""The Redis layer (reference ``faabric_tpu/redis/``): a RESP2 client
and the in-repo mini server that makes ``STATE_MODE=redis`` run without
an outside server."""

from faabric_tpu_torch.redis.client import (
    RedisClient,
    RedisConnectionError,
    RedisError,
    clear_thread_clients,
    get_redis,
)
from faabric_tpu_torch.redis.miniserver import MiniRedisServer

__all__ = [
    "RedisClient",
    "RedisConnectionError",
    "RedisError",
    "MiniRedisServer",
    "clear_thread_clients",
    "get_redis",
]
