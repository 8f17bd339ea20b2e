"""Core FedGBF library, serving half: types, binning, activations, tree
traversal and ensemble prediction."""
