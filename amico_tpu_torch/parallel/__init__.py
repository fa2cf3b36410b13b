from .mesh import DATA_AXIS, make_mesh, masked_mean, replicated, shard_tiles, tile_sharding

__all__ = ['DATA_AXIS', 'make_mesh', 'masked_mean', 'replicated',
           'shard_tiles', 'tile_sharding']
