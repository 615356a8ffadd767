"""``python -m horovod_tpu_torch.runner`` is ``hvdrun``;
``python -m horovod_tpu_torch.runner fleet ...`` is ``hvdfleet``, the
fleet controller of :mod:`horovod_tpu_torch.runner.fleet`."""
import sys


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "fleet":
        from horovod_tpu_torch.runner.fleet import main as fleet_main
        return fleet_main(sys.argv[2:])
    from horovod_tpu_torch.runner.run import main as run_main
    return run_main()


sys.exit(main())
