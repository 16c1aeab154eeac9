"""Data: the h5 episode dataset, its prefetcher, and synthetic data made
from a seed; the single-frame catalog (`catalog`), augmentations and
mapper (`augment`) and tar reader (`tar_dataset`), imported by path."""

from .episode_dataset import EpisodeChunk, EpisodeDataset, sort_episode_files
from .synthetic import SyntheticEpisodes, generate_synthetic_dataset
