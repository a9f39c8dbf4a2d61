from .fault import PreemptionHandler, StepTimer, StragglerMonitor
