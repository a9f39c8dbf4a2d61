from .fault import PreemptionHandler, StepTimer, StragglerMonitor
from .elastic import MeshPlan, plan_mesh, resize_plan
