"""Core FedGBF library: types, binning, objectives, histograms, split
search, tree building and traversal, forests, backends and boosting."""
