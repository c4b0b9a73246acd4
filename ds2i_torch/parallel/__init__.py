from .build_pool import OrderedBuildPool
