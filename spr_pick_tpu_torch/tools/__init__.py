"""Command-line tools of the PyTorch port, each run as
``python -m spr_pick_tpu_torch.tools.<name>`` with the flags of the JAX
package's root script of the same name, without pandas or PIL:

- `convert_to_star`: `*_scores.txt` picks -> one RELION .star;
- `generate_train_files`: a micrograph folder and coordinates -> the TSV
  manifests `train start` reads;
- `dataset_tool_h5`: a folder of images -> an HDF5 dataset (needs h5py);
- `import_reference_checkpoint`: a reference PyTorch `.wt`/`.training` ->
  a file both packages read.
"""
