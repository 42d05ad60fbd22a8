"""Launchers of the port (``serve``, ``train``), the meshes behind them
(``mesh``), and the static tools: ``dryrun`` (every arch x shape x mesh
cell's program for one rank, on meta tensors) and ``op_analysis`` (a
program's cost a device, the counterpart of the reference's
``hlo_analysis``). Nothing is imported here: the launchers spawn
processes that re-import their module."""

__all__ = ["mesh", "train", "serve", "dryrun", "op_analysis"]
