"""The TSP video backbone: R(2+1)D / R3D clip features from raw video
(`tsp.extract_features`), TSP / TAC pretraining (`train_tsp`), the
untrimmed-video clip sampler and the import of released torchvision-named
checkpoints (`import_torch`). Port of gvl_tpu/backbone/."""
