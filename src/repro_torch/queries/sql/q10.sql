select o_custkey, revenue, c_acctbal, c_nationkey
from (select o_custkey, sum(l_extendedprice * (1 - l_discount)) as revenue
      from lineitem
          join orders on l_orderkey = o_orderkey
      where o_orderdate >= date '1993-10-01'
        and o_orderdate < date '1994-01-01'
        and l_returnflag = 'R'
      group by o_custkey) as g
    join customer on o_custkey = c_custkey
order by revenue desc
limit 20
