from .logging import logger, stats_line, ProgressLogger
