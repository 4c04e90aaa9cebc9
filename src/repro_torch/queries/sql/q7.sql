select s_nationkey as supp_nation, c_nationkey as cust_nation,
       year(l_shipdate) as l_year,
       sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem
    join orders on l_orderkey = o_orderkey
    join customer on o_custkey = c_custkey
    join supplier on l_suppkey = s_suppkey
where l_shipdate >= date '1995-01-01'
  and l_shipdate <= date '1996-12-31'
  and s_nationkey in (code('n_name', 'FRANCE'), code('n_name', 'GERMANY'))
  and c_nationkey in (code('n_name', 'FRANCE'), code('n_name', 'GERMANY'))
  and (s_nationkey = code('n_name', 'FRANCE')
         and c_nationkey = code('n_name', 'GERMANY')
       or s_nationkey = code('n_name', 'GERMANY')
         and c_nationkey = code('n_name', 'FRANCE'))
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year
